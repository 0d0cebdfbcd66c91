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
// The kernel walks the plan rows in the order of the plan's launch_rows
// table (int4 a row: row_ptr[r], row_ptr[r+1], rows[r] and the view of r),
// so that a row starts with one coalesced 16-byte load instead of three
// dependent ones. The plans list their rows in plan-row order: the Morton
// order of each row's first pixel measured slower at the main path's
// shapes (PERF.md, Findings). Any order gives the same bits.
//
// The DeepFool pick reads one class of the engine's pixel-major class stack
// in place: row p of g starts at g + p * g_stride, and a plan row of view v
// reads channels cls[v] * C .. cls[v] * C + C - 1 of it. A class that does
// not lie inside the row stops the kernel (__trap, a device fault that the
// next synchronising call reports) instead of reading another pixel's
// channels. Without cls, g is a plain [n_pixels, C] tensor.
//
// Bound: memory. Every pair reads 8 bytes of plan and one 16-byte row of g
// (C = 4); the arithmetic is two flops per pair and channel. A plan row
// has about 5 pairs on the DeepFool path (21 on NeRFail-S's shared point
// set), so each row is a short chain of dependent loads: its launch row,
// pix and w, g. Design:
//   * one group of GROUP lanes a plan row; the lanes stride over the
//     row's pairs (groups walking more rows at once measured no faster);
//   * the gather of g is fused in (the TPU needed a separate XLA gather);
//     for C = 4 it is one 16-byte load per pair;
//   * acc stays in registers; a fixed xor-shuffle tree sums the lanes;
//     each output row is written once. There are no atomics, so the
//     result is bit-identical from run to run, and in any launch order:
//     a row's sum depends only on its own pairs. Products are rounded
//     before the add (no FMA contraction), as in the plain PyTorch
//     version; only the order of the sum differs.

#include <cuda_runtime.h>

namespace {

constexpr int GROUP = 8;                 // lanes per plan row
constexpr int BLOCK = 256;               // threads per block
constexpr int GROUPS = BLOCK / GROUP;    // lane groups (plan rows) per block

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off, GROUP));
  return v;
}

// Where view `view`'s class starts in a row of g: g itself without cls,
// else cls[view] classes of `width` elements on, which must end inside the
// row of `stride` elements.
template <typename T>
__device__ __forceinline__ const T* class_start(const T* g,
                                                const int* __restrict__ cls,
                                                int view, long long width,
                                                long long stride) {
  if (cls == nullptr) return g;
  const int k = __ldg(cls + view);
  if (k < 0 || (k + 1LL) * width > stride) __trap();
  return g + k * width;
}

// C == 4: one 16-byte load of g per pair, one 16-byte store per row. g is
// addressed in float4 units: row stride4, one class a float4.
__global__ void __launch_bounds__(BLOCK)
segsum_c4_kernel(const int4* __restrict__ launch_rows,
                 const int* __restrict__ pix, const float* __restrict__ w,
                 const float4* __restrict__ g, long long stride4,
                 const int* __restrict__ cls, int n_rows,
                 float4* __restrict__ out) {
  const int lane = threadIdx.x % GROUP;
  const int pos = blockIdx.x * GROUPS + threadIdx.x / GROUP;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int orow = 0;
  // every lane stays to the end: the shuffles need the whole warp
  if (pos < n_rows) {
    const int4 lr = __ldg(launch_rows + pos);
    orow = lr.z;
    const float4* gc = class_start(g, cls, lr.w, 1, stride4);
    for (int p = lr.x + lane; p < lr.y; p += GROUP) {
      const float wp = __ldg(w + p);
      const float4 gv = __ldg(gc + __ldg(pix + p) * stride4);
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
  if (pos < n_rows && lane == 0) out[orow] = acc;
}

// Any C <= CMAX: acc[] indexed only by unrolled constants, so it stays in
// registers; lane c % GROUP writes channel c.
template <int CMAX>
__global__ void __launch_bounds__(BLOCK)
segsum_kernel(const int4* __restrict__ launch_rows,
              const int* __restrict__ pix, const float* __restrict__ w,
              const float* __restrict__ g, long long stride,
              const int* __restrict__ cls, int n_rows, int channels,
              float* __restrict__ out) {
  const int lane = threadIdx.x % GROUP;
  const int pos = blockIdx.x * GROUPS + threadIdx.x / GROUP;
  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;
  int orow = 0;
  if (pos < n_rows) {
    const int4 lr = __ldg(launch_rows + pos);
    orow = lr.z;
    const float* gc = class_start(g, cls, lr.w, channels, stride);
    for (int p = lr.x + lane; p < lr.y; p += GROUP) {
      const float wp = __ldg(w + p);
      const float* gr = gc + static_cast<long long>(__ldg(pix + p)) * stride;
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < channels) acc[c] = __fadd_rn(acc[c], __fmul_rn(wp, __ldg(gr + c)));
    }
  }
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = group_sum(acc[c]);
  if (pos < n_rows) {
    float* o = out + static_cast<long long>(orow) * channels;
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < channels && c % GROUP == lane) o[c] = acc[c];
  }
}

template <int CMAX>
void launch_any(const int4* lr, const int* px, const float* wt, const void* g,
                long long stride, const int* cl, int n_rows, int channels,
                void* out, cudaStream_t s) {
  const dim3 grid((n_rows + GROUPS - 1) / GROUPS);
  segsum_kernel<CMAX><<<grid, BLOCK, 0, s>>>(
      lr, px, wt, static_cast<const float*>(g), stride, cl, n_rows, channels,
      static_cast<float*>(out));
}

}  // namespace

// out[rows[r], :] for the n_rows plan rows r, walked through launch_rows
// (int4 [n_rows], 16-byte aligned), from the CSR's pix and w and g, whose
// pixel p's row starts at g + p * g_stride (floats). With cls (int [V]) a
// row of view v reads channels cls[v] * channels onwards of that row, and
// the kernel traps on a class that does not end inside the row; cls may be
// null. For channels == 4, g, g_stride and out must be 16-byte
// aligned. All pointers are device pointers; returns cudaGetLastError().
extern "C" int segsum_launch(const void* launch_rows, const void* pix,
                             const void* w, const void* g, const void* cls,
                             void* out, int n_rows, int channels,
                             long long g_stride, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  if (channels < 1 || channels > 32 || g_stride < channels)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* lr = static_cast<const int4*>(launch_rows);
  const int* px = static_cast<const int*>(pix);
  const float* wt = static_cast<const float*>(w);
  const int* cl = static_cast<const int*>(cls);
  if (channels == 4) {
    if (g_stride % 4) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((n_rows + GROUPS - 1) / GROUPS);
    segsum_c4_kernel<<<grid, BLOCK, 0, s>>>(
        lr, px, wt, static_cast<const float4*>(g), g_stride / 4, cl, n_rows,
        static_cast<float4*>(out));
  } else if (channels < 4) {
    launch_any<4>(lr, px, wt, g, g_stride, cl, n_rows, channels, out, s);
  } else if (channels <= 8) {
    launch_any<8>(lr, px, wt, g, g_stride, cl, n_rows, channels, out, s);
  } else if (channels <= 16) {
    launch_any<16>(lr, px, wt, g, g_stride, cl, n_rows, channels, out, s);
  } else {
    launch_any<32>(lr, px, wt, g, g_stride, cl, n_rows, channels, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
