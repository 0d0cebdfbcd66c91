// Exact 8-NN over pruned candidate tiles, for Hopper (sm_90a).
//
// Replaces the TPU kernel nerfail_tpu/ops/pallas/knn_kernel.py
// `_knn_kernel` (driven by `_knn_call` / `knn_pallas`). For every query,
// the 8 points of smallest squared Euclidean distance over its tile's
// candidate point tiles, ascending, with their indices in the
// Morton-sorted point order; the wrapper takes the square root and undoes
// both permutations.
//
// Bound: fp32 arithmetic outside the tensor cores. Each (query, candidate
// point) pair costs 8 rounded operations (3 sub, 3 mul, 2 add; no FMA
// contraction, as the TPU kernel computes d² in f32), so the pruning,
// which sets the pair count, sets the time.
//
// Load balance. The plan (ops/cuda/knn_kernel.py) gives each query tile
// of TQ = 256 queries a CSR row of candidate point tiles, nearest lower
// bound first. Rows are very uneven: an 800² view has a median of 67
// tiles and a largest row of 3709, whose query tiles straddle a jump of
// the Morton curve. One block per row made that row a serial job. So:
//   * knn_search_kernel runs one block per work item, at most C
//     consecutive candidate tiles of one row (the wrapper cuts the rows
//     and launches the items largest first). An item that is its row's
//     only one writes the output; the others write a partial top-8 each
//     to scratch;
//   * knn_merge_kernel merges each split row's partial lists in item
//     order and writes the output.
//
// Why the split is exact, ties included. The insert below places a new
// d² after every kept entry ≤ it (strict `<`), starting from 8 entries of
// (inf, 0). So one scan of a row keeps the first 8 entries of a stable
// sort by d² of [8 × (inf, 0), the row's points in scan order]. Cut the
// scan into consecutive chunks: an entry that is not among the first 8 of
// its own chunk's stable sort has 8 entries of that chunk before it, and
// they precede it in the whole sort too; so the first 8 of the whole are
// the first 8 of the stable merge of the chunks' own lists in chunk order
// (equal d²: the earlier chunk first). The merge inserts each chunk's list
// in order with the same rule, which is that stable merge. Split + merge
// is bit-equal to one scan of the row.
//
// The block's inner loop: 128 threads, QPT = 2 queries each, so one
// broadcast 16-byte shared load of a point serves two pairs. Point tiles
// of TP = 512 points (x, y, z, 0) stream through a 3-stage ring in shared
// memory, filled by cp.async one tile ahead of the one being consumed,
// with one __syncthreads per tile. The running top-8s live in registers.
// Points past m_total (tile padding) are skipped.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int K = 8;                  // neighbours kept
constexpr int TQ = 256;               // queries per tile
constexpr int TP = 512;               // points per candidate tile
constexpr int QPT = 2;                // queries per search thread
constexpr int THREADS = TQ / QPT;     // search block
constexpr int STAGES = 3;             // point tiles in the ring
constexpr int COPIES = TP / THREADS;  // 16-byte copies per thread per tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void load_tile(float4* dst, const float4* p,
                                          int tile) {
  const float4* src = p + static_cast<long long>(tile) * TP;
#pragma unroll
  for (int c = 0; c < COPIES; ++c)
    cp_async16(dst + threadIdx.x + c * THREADS, src + threadIdx.x + c * THREADS);
}

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float4 pt) {
  const float dx = __fsub_rn(qx, pt.x);
  const float dy = __fsub_rn(qy, pt.y);
  const float dz = __fsub_rn(qz, pt.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// sorted insert after every kept entry ≤ d2, top down; bd[t-1] is still
// unmodified at step t. A d2 that is not < bd[K-1] changes nothing.
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d2,
                                       int id) {
#pragma unroll
  for (int t = K - 1; t > 0; --t) {
    if (d2 < bd[t]) {
      if (d2 < bd[t - 1]) { bd[t] = bd[t - 1]; bi[t] = bi[t - 1]; }
      else                { bd[t] = d2;        bi[t] = id; }
    }
  }
  if (d2 < bd[0]) { bd[0] = d2; bi[0] = id; }
}

__device__ __forceinline__ void init8(float (&bd)[K], int (&bi)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) { bd[k] = CUDART_INF_F; bi[k] = 0; }
}

__device__ __forceinline__ void store8(float* d, int* i, const float (&bd)[K],
                                       const int (&bi)[K]) {
  reinterpret_cast<float4*>(d)[0] = make_float4(bd[0], bd[1], bd[2], bd[3]);
  reinterpret_cast<float4*>(d)[1] = make_float4(bd[4], bd[5], bd[6], bd[7]);
  reinterpret_cast<int4*>(i)[0] = make_int4(bi[0], bi[1], bi[2], bi[3]);
  reinterpret_cast<int4*>(i)[1] = make_int4(bi[4], bi[5], bi[6], bi[7]);
}

// items[b] = (query tile, first slot in `tiles`, tile count, scratch slot
// or -1 for a row's only item); thread t holds queries t + u·THREADS
__global__ void __launch_bounds__(THREADS)
knn_search_kernel(const float* __restrict__ q, const float4* __restrict__ p,
                  const int* __restrict__ tiles, const int4* __restrict__ items,
                  int m_total, float* __restrict__ out_d, int* __restrict__ out_i,
                  float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float4 ring[STAGES][TP];
  const int4 item = items[blockIdx.x];
  const int row = item.x, first = item.y, count = item.z, slot = item.w;
  float qx[QPT], qy[QPT], qz[QPT], bd[QPT][K];
  int bi[QPT][K];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const long long qi = static_cast<long long>(row) * TQ + threadIdx.x + u * THREADS;
    qx[u] = q[qi * 3];
    qy[u] = q[qi * 3 + 1];
    qz[u] = q[qi * 3 + 2];
    init8(bd[u], bi[u]);
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < count) load_tile(ring[s], p, tiles[first + s]);
    cp_async_commit();
  }
  for (int j = 0; j < count; ++j) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of tile j landed
    __syncthreads();               // everyone's; and tile j-1 is consumed
    const int nj = j + STAGES - 1;
    if (nj < count) load_tile(ring[nj % STAGES], p, tiles[first + nj]);
    cp_async_commit();             // (an empty group past the row's end)
    const float4* sp = ring[j % STAGES];
    const int off = tiles[first + j] * TP;
    const int n = min(TP, m_total - off);
#pragma unroll 4
    for (int l = 0; l < n; ++l) {
      const float4 pt = sp[l];
      float d2[QPT];
      bool in[QPT], any = false;
#pragma unroll
      for (int u = 0; u < QPT; ++u) {
        d2[u] = sq_dist(qx[u], qy[u], qz[u], pt);
        in[u] = d2[u] < bd[u][K - 1];
        any |= in[u];
      }
      if (any) {
#pragma unroll
        for (int u = 0; u < QPT; ++u)
          if (in[u]) insert(bd[u], bi[u], d2[u], off + l);
      }
    }
  }
  cp_async_wait<0>();

  float* od = slot < 0 ? out_d : part_d;
  int* oi = slot < 0 ? out_i : part_i;
  const long long r0 = static_cast<long long>(slot < 0 ? row : slot) * TQ + threadIdx.x;
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const long long r = (r0 + u * THREADS) * K;
    store8(od + r, oi + r, bd[u], bi[u]);
  }
}

// merges[b] = (query tile, first scratch slot, items); one thread a query
__global__ void __launch_bounds__(TQ)
knn_merge_kernel(const int* __restrict__ merges,
                 const float* __restrict__ part_d,
                 const int* __restrict__ part_i, float* __restrict__ out_d,
                 int* __restrict__ out_i) {
  const int row = merges[blockIdx.x * 3];
  const int first = merges[blockIdx.x * 3 + 1];
  const int n = merges[blockIdx.x * 3 + 2];
  float bd[K];
  int bi[K];
  init8(bd, bi);
  for (int s = 0; s < n; ++s) {
    const long long r = (static_cast<long long>(first + s) * TQ + threadIdx.x) * K;
    const float4 d0 = reinterpret_cast<const float4*>(part_d + r)[0];
    const float4 d1 = reinterpret_cast<const float4*>(part_d + r)[1];
    const int4 i0 = reinterpret_cast<const int4*>(part_i + r)[0];
    const int4 i1 = reinterpret_cast<const int4*>(part_i + r)[1];
    const float pd[K] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
    const int pi[K] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
#pragma unroll
    for (int e = 0; e < K; ++e) insert(bd, bi, pd[e], pi[e]);
  }
  const long long o = (static_cast<long long>(row) * TQ + threadIdx.x) * K;
  store8(out_d + o, out_i + o, bd, bi);
}

}  // namespace

// q [n_qtiles*TQ, 3] f32, p [mp, 4] f32 (x, y, z, 0), tiles int32 (the
// plan's CSR column ids), items int32 [n_items, 4] → out_d/out_i
// [n_qtiles*TQ, 8] (f32 squared distances, int32 indices) for rows of one
// item, part_d/part_i [scratch slots*TQ, 8] for the others. All pointers
// are device pointers; returns cudaGetLastError().
extern "C" int knn_search_launch(const void* q, const void* p,
                                 const void* tiles, const void* items,
                                 int n_items, int m_total, void* out_d,
                                 void* out_i, void* part_d, void* part_i,
                                 void* stream) {
  if (n_items <= 0) return static_cast<int>(cudaGetLastError());
  knn_search_kernel<<<n_items, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float4*>(p),
      static_cast<const int*>(tiles), static_cast<const int4*>(items), m_total,
      static_cast<float*>(out_d), static_cast<int*>(out_i),
      static_cast<float*>(part_d), static_cast<int*>(part_i));
  return static_cast<int>(cudaGetLastError());
}

// merges int32 [n_merges, 3]; part_d/part_i from knn_search_launch →
// the split rows of out_d/out_i.
extern "C" int knn_merge_launch(const void* merges, int n_merges,
                                const void* part_d, const void* part_i,
                                void* out_d, void* out_i, void* stream) {
  if (n_merges <= 0) return static_cast<int>(cudaGetLastError());
  knn_merge_kernel<<<n_merges, TQ, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(merges), static_cast<const float*>(part_d),
      static_cast<const int*>(part_i), static_cast<float*>(out_d),
      static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
