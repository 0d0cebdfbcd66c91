// Squared norms of the splat-backward segmented sum, per view, for Hopper
// (sm_90a): the class-norm pass of the batched DeepFool engine.
//
// Replaces the TPU kernel nerfail_tpu/ops/pallas/segsum_kernel.py
// `_segsum_sq_kernel` (driven by `_part_compact_sq`, exposed as
// `planned_segment_sq[_T]`):
//
//     sq[v, c] = sum over plan rows r of view v of
//                (sum over the pairs p of row r of  w[p] * g[pix[p], c])^2
//
// The plan is K1's batched CSR plan (row_ptr [R+1], pix [P], w [P]) with
// view_ptr [V+1]: view v owns plan rows view_ptr[v]:view_ptr[v+1]. Only
// touched rows are listed; untouched rows would add zero. The TPU kernel
// emits one partial per 512-point chunk, with sublane padding; the port
// returns per-view sums.
//
// Bound: memory. Every pair reads 8 bytes of plan and one row of g
// (4 * channels bytes, up to 128 for the 8 classes x RGBA of DeepFool);
// the arithmetic is two flops per pair and channel. Design:
//   * one group of GROUP lanes per plan row; lane l owns channels
//     l, l + 8, l + 16, l + 24, so the 8 lanes read a row of g as
//     contiguous 32-byte runs and no shuffle is needed; each lane walks the
//     row's pairs in plan order, fp32 sums in registers, products rounded
//     before the add (no FMA contraction), as in the plain version;
//   * each row's sums are squared in registers and never written; a lane
//     adds the squares of its ROWS_PER_GROUP rows;
//   * pass 1: block (x, v) covers ROWS_PER_BLOCK consecutive rows of view v
//     and sums its lane groups in shared memory in a fixed order into
//     partial[v, x, c];
//   * pass 2: one block per (c, v) adds view v's partials, strided by
//     thread and then by a halving tree, in a fixed order.
// There are no float atomics, so the result is bit-identical from run to
// run: the DeepFool argmin depends on these values. The Python wrapper's
// sq_error_bound mirrors this tree (SQ_* constants in segsum_kernel.py).

#include <cuda_runtime.h>

namespace {

constexpr int GROUP = 8;                       // lanes per plan row
constexpr int BLOCK = 256;                     // threads of pass 1
constexpr int GROUPS = BLOCK / GROUP;          // rows in flight per block
constexpr int ROWS_PER_GROUP = 4;
constexpr int ROWS_PER_BLOCK = GROUPS * ROWS_PER_GROUP;
constexpr int REDUCE = 256;                    // threads of pass 2

template <int CPL>   // channels per lane; handles channels <= CPL * GROUP
__global__ void __launch_bounds__(BLOCK)
segsq_partial_kernel(const int* __restrict__ row_ptr,
                     const int* __restrict__ view_ptr,
                     const int* __restrict__ pix, const float* __restrict__ w,
                     const float* __restrict__ g, int n_chunks, int channels,
                     float* __restrict__ partial) {
  const int v = blockIdx.y;
  const int lane = threadIdx.x % GROUP;
  const int group = threadIdx.x / GROUP;
  const int end = __ldg(view_ptr + v + 1);
  const int base = __ldg(view_ptr + v) + blockIdx.x * ROWS_PER_BLOCK + group;
  float sq[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) sq[j] = 0.f;
  for (int i = 0; i < ROWS_PER_GROUP; ++i) {
    const int r = base + i * GROUPS;
    if (r >= end) break;
    float acc[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
    const int pend = __ldg(row_ptr + r + 1);
    for (int p = __ldg(row_ptr + r); p < pend; ++p) {
      const float wp = __ldg(w + p);
      const float* gr = g + static_cast<long long>(__ldg(pix + p)) * channels;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + GROUP * j;
        if (c < channels) acc[j] = __fadd_rn(acc[j], __fmul_rn(wp, __ldg(gr + c)));
      }
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j) sq[j] = __fadd_rn(sq[j], __fmul_rn(acc[j], acc[j]));
  }
  __shared__ float part[GROUPS][CPL * GROUP];
#pragma unroll
  for (int j = 0; j < CPL; ++j) part[group][lane + GROUP * j] = sq[j];
  __syncthreads();
  if (threadIdx.x < channels) {
    float s = 0.f;
    for (int q = 0; q < GROUPS; ++q) s = __fadd_rn(s, part[q][threadIdx.x]);
    partial[(static_cast<long long>(v) * n_chunks + blockIdx.x) * channels +
            threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(REDUCE)
segsq_reduce_kernel(const float* __restrict__ partial, int n_chunks,
                    int channels, float* __restrict__ out) {
  const int c = blockIdx.x;
  const int v = blockIdx.y;
  const float* p = partial + static_cast<long long>(v) * n_chunks * channels + c;
  float s = 0.f;
  for (int x = threadIdx.x; x < n_chunks; x += REDUCE)
    s = __fadd_rn(s, p[static_cast<long long>(x) * channels]);
  __shared__ float buf[REDUCE];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int off = REDUCE / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off)
      buf[threadIdx.x] = __fadd_rn(buf[threadIdx.x], buf[threadIdx.x + off]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[v * channels + c] = buf[0];
}

}  // namespace

// out[n_views, channels] from the batched CSR plan and g[n_pixels, channels];
// partial is scratch of [n_views, n_chunks, channels] with n_chunks blocks
// of ROWS_PER_BLOCK rows covering the largest view. All pointers are device
// pointers; returns cudaGetLastError().
extern "C" int segsum_sq_launch(const void* row_ptr, const void* view_ptr,
                                const void* pix, const void* w, const void* g,
                                void* partial, void* out, int n_views,
                                int n_chunks, int channels, void* stream) {
  if (n_views <= 0 || n_chunks <= 0 || n_views > 65535 || channels <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_chunks, n_views);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* vp = static_cast<const int*>(view_ptr);
  const int* px = static_cast<const int*>(pix);
  const float* wt = static_cast<const float*>(w);
  const float* gg = static_cast<const float*>(g);
  float* pt = static_cast<float*>(partial);
  if (channels <= 8) {
    segsq_partial_kernel<1><<<grid, BLOCK, 0, s>>>(rp, vp, px, wt, gg,
                                                   n_chunks, channels, pt);
  } else if (channels <= 16) {
    segsq_partial_kernel<2><<<grid, BLOCK, 0, s>>>(rp, vp, px, wt, gg,
                                                   n_chunks, channels, pt);
  } else if (channels <= 32) {
    segsq_partial_kernel<4><<<grid, BLOCK, 0, s>>>(rp, vp, px, wt, gg,
                                                   n_chunks, channels, pt);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segsq_reduce_kernel<<<dim3(channels, n_views), REDUCE, 0, s>>>(
      pt, n_chunks, channels, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
