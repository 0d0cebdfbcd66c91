// Exact 8-NN over host-pruned candidate tiles, for Hopper (sm_90a).
//
// Replaces the TPU kernel nerfail_tpu/ops/pallas/knn_kernel.py
// `_knn_kernel` (driven by `_knn_call` / `knn_pallas`). For every query,
// the 8 points of smallest squared Euclidean distance, ascending, with
// their indices in the Morton-sorted point order; the host takes the
// square root and undoes both permutations.
//
// Bound: fp32 arithmetic outside the tensor cores, about 8 operations per
// (query, candidate point) pair. The candidate table (host bbox pruning,
// exact) keeps the pair count near what the 8-NN actually needs. Design:
//   * one block per query tile (TQ = 256 queries), one thread per query;
//   * the block walks the tile's candidate point tiles in table order
//     (nearest bound first), staging each tile of TP = 512 points in
//     shared memory as float4, so every thread reads each point with one
//     broadcast 16-byte shared load;
//   * d² = (dx² + dy²) + dz² with explicit round-to-nearest intrinsics,
//     no FMA contraction, as the TPU kernel computes it in f32;
//   * the running top-8 (d², idx) lives in registers; a candidate goes in
//     only on a strict `<`, so ties keep the earlier entry: the lowest
//     lane within a tile and kept-before-new across tiles, the TPU
//     kernel's rules. Points past m_total (tile padding) are skipped.
// The candidate table is read from device memory: no scalar-prefetch
// budget, so no width bucketing or segmented passes.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int K = 8;      // neighbours kept
constexpr int TQ = 256;   // queries per tile (threads per block)
constexpr int TP = 512;   // points per candidate tile

__global__ void __launch_bounds__(TQ)
knn_kernel(const float* __restrict__ q, const float* __restrict__ p,
           const int* __restrict__ cand, int max_c, int mp, int m_total,
           float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float4 sp[TP];
  const long long qi = static_cast<long long>(blockIdx.x) * TQ + threadIdx.x;
  const float qx = q[qi * 3], qy = q[qi * 3 + 1], qz = q[qi * 3 + 2];
  float bd[K];
  int bi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) { bd[k] = CUDART_INF_F; bi[k] = 0; }

  const int* row = cand + static_cast<long long>(blockIdx.x) * max_c;
  for (int s = 0; s < max_c; ++s) {
    const int jt = row[s];              // uniform across the block
    if (jt < 0) break;                  // rows are left-packed
    const int off = jt * TP;
    __syncthreads();                    // previous tile fully consumed
    for (int l = threadIdx.x; l < TP; l += TQ)
      sp[l] = make_float4(p[off + l], p[mp + off + l], p[2 * mp + off + l], 0.f);
    __syncthreads();
    const int n = min(TP, m_total - off);
    for (int l = 0; l < n; ++l) {
      const float4 pt = sp[l];
      const float dx = __fsub_rn(qx, pt.x);
      const float dy = __fsub_rn(qy, pt.y);
      const float dz = __fsub_rn(qz, pt.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 < bd[K - 1]) {
        const int id = off + l;
        // sorted insert, top down; bd[t-1] is still unmodified at step t
#pragma unroll
        for (int t = K - 1; t > 0; --t) {
          if (d2 < bd[t]) {
            if (d2 < bd[t - 1]) { bd[t] = bd[t - 1]; bi[t] = bi[t - 1]; }
            else                { bd[t] = d2;        bi[t] = id; }
          }
        }
        if (d2 < bd[0]) { bd[0] = d2; bi[0] = id; }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    out_d[qi * K + k] = bd[k];
    out_i[qi * K + k] = bi[k];
  }
}

}  // namespace

// q [n_qtiles*TQ, 3] f32, p [3, mp] f32, cand [n_qtiles, max_c] int32 (-1
// padded) → out_d [n_qtiles*TQ, 8] f32 (squared), out_i [·, 8] int32.
// All pointers are device pointers; returns cudaGetLastError().
extern "C" int knn_launch(const void* q, const void* p, const void* cand,
                          int n_qtiles, int max_c, int mp, int m_total,
                          void* out_d, void* out_i, void* stream) {
  if (n_qtiles <= 0) return static_cast<int>(cudaGetLastError());
  knn_kernel<<<n_qtiles, TQ, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(p),
      static_cast<const int*>(cand), max_c, mp, m_total,
      static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
