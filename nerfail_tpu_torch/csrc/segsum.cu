// Splat-backward segmented reduction for Hopper (sm_90a).
//
// Replaces the TPU kernel nerfail_tpu/ops/pallas/segsum_kernel.py
// `_segsum_kernel` (driven by `_part_compact_sums`, exposed as
// `planned_segment_sum`):
//
//     out[m, c] = sum over the pairs p of point m of  w[p] * g[pix[p], c]
//
// The pairs come in a CSR plan sorted by output row (row_ptr [R+1], pix [P],
// w [P]); within a row they keep ascending pixel order. The plan lists only
// the touched rows (rows [R], the output row of each plan row); the wrapper
// zero-fills the output first. The TPU design
// (512-id chunks, width classes, a one-hot MXU contraction, a separate XLA
// gather) only worked around the TPU's lack of a fast scatter; none of it
// is needed here.
//
// Bound: memory. Every pair reads 8 bytes of plan and one 16-byte row of g
// (C = 4); the arithmetic is two flops per pair and channel. Design:
//   * one group of GROUP lanes per plan row; the lanes stride over the
//     row's pairs, so the plan is read in coalesced runs and a long
//     segment is shared by 8 lanes instead of stalling one thread;
//   * the gather of g is fused in (the TPU needed a separate XLA gather);
//     for C = 4 it is one 16-byte load per pair;
//   * acc[C] stays in registers; a fixed xor-shuffle tree sums the lanes;
//     each output row is written once. There are no atomics, so the
//     result is bit-identical from run to run. Products are rounded
//     before the add (no FMA contraction), as
//     in the plain PyTorch version; only the order of the sum differs.

#include <cuda_runtime.h>

namespace {

constexpr int GROUP = 8;     // lanes per point
constexpr int BLOCK = 256;   // threads per block: BLOCK / GROUP points

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off, GROUP));
  return v;
}

// C == 4: one 16-byte load of g per pair, one 16-byte store per point.
__global__ void __launch_bounds__(BLOCK)
segsum_c4_kernel(const int* __restrict__ row_ptr, const int* __restrict__ rows,
                 const int* __restrict__ pix, const float* __restrict__ w,
                 const float4* __restrict__ g, int n_points,
                 float4* __restrict__ out) {
  const int lane = threadIdx.x % GROUP;
  const int point = blockIdx.x * (BLOCK / GROUP) + threadIdx.x / GROUP;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // every lane stays to the end: the shuffles need the whole warp
  if (point < n_points) {
    const int end = row_ptr[point + 1];
    for (int p = row_ptr[point] + lane; p < end; p += GROUP) {
      const float wp = __ldg(w + p);
      const float4 gv = __ldg(g + __ldg(pix + p));
      acc.x = __fadd_rn(acc.x, __fmul_rn(wp, gv.x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(wp, gv.y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(wp, gv.z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(wp, gv.w));
    }
  }
  acc.x = group_sum(acc.x);
  acc.y = group_sum(acc.y);
  acc.z = group_sum(acc.z);
  acc.w = group_sum(acc.w);
  if (point < n_points && lane == 0) out[__ldg(rows + point)] = acc;
}

// Any C <= CMAX: acc[] indexed only by unrolled constants, so it stays in
// registers; lane c % GROUP writes channel c.
template <int CMAX>
__global__ void __launch_bounds__(BLOCK)
segsum_kernel(const int* __restrict__ row_ptr, const int* __restrict__ rows,
              const int* __restrict__ pix, const float* __restrict__ w,
              const float* __restrict__ g, int n_points, int channels,
              float* __restrict__ out) {
  const int lane = threadIdx.x % GROUP;
  const int point = blockIdx.x * (BLOCK / GROUP) + threadIdx.x / GROUP;
  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;
  if (point < n_points) {
    const int end = row_ptr[point + 1];
    for (int p = row_ptr[point] + lane; p < end; p += GROUP) {
      const float wp = __ldg(w + p);
      const float* gr = g + static_cast<long long>(__ldg(pix + p)) * channels;
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < channels) acc[c] = __fadd_rn(acc[c], __fmul_rn(wp, __ldg(gr + c)));
    }
  }
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = group_sum(acc[c]);
  if (point < n_points) {
    float* o = out + static_cast<long long>(__ldg(rows + point)) * channels;
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < channels && c % GROUP == lane) o[c] = acc[c];
  }
}

}  // namespace

// out[rows[r], :] for the n_points plan rows r, from the CSR plan and
// g[n_pixels, channels]. All pointers are device pointers; returns
// cudaGetLastError().
extern "C" int segsum_launch(const void* row_ptr, const void* rows,
                             const void* pix, const void* w, const void* g,
                             void* out, int n_points, int channels,
                             void* stream) {
  if (n_points <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n_points + BLOCK / GROUP - 1) / (BLOCK / GROUP));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* ro = static_cast<const int*>(rows);
  const int* px = static_cast<const int*>(pix);
  const float* wt = static_cast<const float*>(w);
  if (channels == 4) {
    segsum_c4_kernel<<<grid, BLOCK, 0, s>>>(
        rp, ro, px, wt, static_cast<const float4*>(g), n_points,
        static_cast<float4*>(out));
  } else if (channels < 4) {
    segsum_kernel<4><<<grid, BLOCK, 0, s>>>(
        rp, ro, px, wt, static_cast<const float*>(g), n_points, channels,
        static_cast<float*>(out));
  } else if (channels <= 8) {
    segsum_kernel<8><<<grid, BLOCK, 0, s>>>(
        rp, ro, px, wt, static_cast<const float*>(g), n_points, channels,
        static_cast<float*>(out));
  } else if (channels <= 16) {
    segsum_kernel<16><<<grid, BLOCK, 0, s>>>(
        rp, ro, px, wt, static_cast<const float*>(g), n_points, channels,
        static_cast<float*>(out));
  } else if (channels <= 32) {
    segsum_kernel<32><<<grid, BLOCK, 0, s>>>(
        rp, ro, px, wt, static_cast<const float*>(g), n_points, channels,
        static_cast<float*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
