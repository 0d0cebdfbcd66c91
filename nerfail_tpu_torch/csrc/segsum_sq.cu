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
// (4 * channels bytes: 128 for the 8 classes x RGBA of DeepFool); the
// arithmetic is two flops per pair and channel. A plan row has about 5
// pairs at the main path's shapes (at most 18). Measured on the H100
// (PERF.md, Findings): with every gather served from L1, the old layout (8
// lanes a row, 4 scalar channels a lane) still took most of its time,
// because each of a row's 8 lanes repeats the pair's index loads and loop
// for 4 channels; the gathers' bytes were the smaller part. Design:
//   * plan rows run in the order of the plan's launch_rows table (int4 a
//     row: row_ptr[r], row_ptr[r+1], rows[r], view), so a row starts with
//     one coalesced 16-byte load; the plans list their rows in plan-row
//     order, which measured faster for this kernel than the Morton order
//     of each row's first pixel (PERF.md, Findings);
//   * C % 4 == 0 with C / 4 a power of two (the vector path): a row's
//     GROUP lanes share each pair's row of g as coalesced 16-byte loads;
//     at C = 32, 4 lanes of 8 channels (two quads each) make one 128-byte
//     request, so the per-pair bookkeeping is spread over 8 channels a
//     lane; for C < 4 * GROUP the lanes also split the pairs into slots;
//   * a group walks RI rows at once, their loads issued together;
//   * each row's sums stay in registers (fp32, products rounded before
//     the add, no FMA contraction, as in the plain version; a lane adds
//     its pairs in plan order, the pair slots meet in a fixed xor tree),
//     are squared there and never written; a lane adds the squares of its
//     ROWS_PER_GROUP rows;
//   * block (x, v) covers ROWS_PER_BLOCK rows of view v in launch order and
//     sums its lane groups in shared memory in a fixed order into
//     partial[v, x, c]; the last block of the view to finish (an integer
//     ticket, one 128-byte line a view) then adds the view's partials in
//     chunk order in a fixed layout (FIN strided runs, then their FIN
//     sums), whichever block that is;
//   * other C <= 32 (the scalar path): lane l owns channels l, l + GROUP,
//     ..., one pair at a time, in the same blocks and the same final sum.
// There are no float atomics, so the result is bit-identical from run to
// run: the DeepFool argmin depends on these values. The Python wrapper's
// sq_error_bound mirrors this tree (SQ_* constants in segsum_kernel.py).

#include <cuda_runtime.h>

namespace {

constexpr int GROUP = 4;                       // lanes per plan row
constexpr int BLOCK = 256;                     // threads per block
constexpr int GROUPS = BLOCK / GROUP;          // lane groups per block
constexpr int ROWS_PER_GROUP = 8;              // plan rows a group squares
constexpr int ROWS_PER_BLOCK = GROUPS * ROWS_PER_GROUP;
constexpr int RI = 2;                          // rows a group walks at once
constexpr int U = 2;                           // pairs a lane loads per step
constexpr int FIN = 8;                         // strided runs of the final sum
constexpr int BATCH = 8;                       // partials loaded at once
constexpr int MAXC = 32;
constexpr int TICKET_STRIDE = 32;              // ints between views' tickets

static_assert(ROWS_PER_GROUP % RI == 0, "rows walked in whole steps");
static_assert(FIN * MAXC == BLOCK, "final sum: FIN threads per channel");

// sq[v, c] for c < channels from view v's n_chunks partials, in a fixed
// layout: thread (j, c) adds chunks j, j + FIN, ... in order (BATCH loads
// in flight), then thread c adds the FIN runs in order. partial is read
// through L2 (written by other blocks).
__device__ void reduce_view(const float* partial, int n_chunks, int channels,
                            float* out) {
  __shared__ float runs[FIN][MAXC];
  const int c = threadIdx.x % MAXC;
  const int j = threadIdx.x / MAXC;
  float s = 0.f;
  if (c < channels) {
    for (int x0 = j; x0 < n_chunks; x0 += FIN * BATCH) {
      float b[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int x = x0 + FIN * k;
        b[k] = x < n_chunks
                   ? __ldcg(partial + static_cast<long long>(x) * channels + c)
                   : 0.f;
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k)
        if (x0 + FIN * k < n_chunks) s = __fadd_rn(s, b[k]);
    }
  }
  runs[j][c] = s;
  __syncthreads();
  if (threadIdx.x < channels) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < FIN; ++q) t = __fadd_rn(t, runs[q][threadIdx.x]);
    out[threadIdx.x] = t;
  }
}

// The block's per-channel sums of its groups' squares (part[group][c],
// added over groups in order) into partial[v, x, :]; the last block of
// view v to finish then reduces the view and resets its ticket.
__device__ void block_partial(float (*part)[MAXC], int channels, int n_chunks,
                              float* partial, unsigned* tickets, float* out) {
  const int v = blockIdx.y;
  __syncthreads();
  float* pv = partial + static_cast<long long>(v) * n_chunks * channels;
  if (threadIdx.x < channels) {
    float s = 0.f;
    for (int q = 0; q < GROUPS; ++q) s = __fadd_rn(s, part[q][threadIdx.x]);
    pv[static_cast<long long>(blockIdx.x) * channels + threadIdx.x] = s;
    __threadfence();
  }
  __syncthreads();
  __shared__ bool last;
  unsigned* ticket = tickets + v * TICKET_STRIDE;
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == static_cast<unsigned>(n_chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  reduce_view(pv, n_chunks, channels, out + v * channels);
  if (threadIdx.x == 0) *ticket = 0u;
}

// acc += w * g, each product rounded before the add (no FMA contraction)
__device__ __forceinline__ void axpy(float4& acc, float w, const float4& g) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, g.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, g.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, g.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, g.w));
}

__device__ __forceinline__ void add_square(float4& sq, const float4& a) {
  sq.x = __fadd_rn(sq.x, __fmul_rn(a.x, a.x));
  sq.y = __fadd_rn(sq.y, __fmul_rn(a.y, a.y));
  sq.z = __fadd_rn(sq.z, __fmul_rn(a.z, a.z));
  sq.w = __fadd_rn(sq.w, __fmul_rn(a.w, a.w));
}

__device__ __forceinline__ float4 shfl_xor4(const float4& a, int off) {
  return make_float4(__shfl_xor_sync(0xffffffffu, a.x, off, GROUP),
                     __shfl_xor_sync(0xffffffffu, a.y, off, GROUP),
                     __shfl_xor_sync(0xffffffffu, a.z, off, GROUP),
                     __shfl_xor_sync(0xffffffffu, a.w, off, GROUP));
}

// The vector path: Q channel quads per pair (C = 4 Q). NQ lanes share a
// pair, QPL quads each; the group's GROUP / NQ pair slots split the pairs.
template <int Q>
__global__ void __launch_bounds__(BLOCK)
segsq_vec_kernel(const int4* __restrict__ launch_rows,
                 const int* __restrict__ view_ptr,
                 const int* __restrict__ pix, const float* __restrict__ w,
                 const float4* __restrict__ g, int n_chunks,
                 float* __restrict__ partial, unsigned* __restrict__ tickets,
                 float* __restrict__ out) {
  constexpr int NQ = Q < GROUP ? Q : GROUP;    // lanes on one pair
  constexpr int QPL = Q / NQ;                  // quads per lane
  constexpr int S = GROUP / NQ;                // pair slots per row
  const int v = blockIdx.y;
  const int lane = threadIdx.x % GROUP;
  const int group = threadIdx.x / GROUP;
  const int quad = (lane % NQ) * QPL;          // the lane's first quad
  const int slot = lane / NQ;
  const int vend = __ldg(view_ptr + v + 1);
  const int base = __ldg(view_ptr + v) + blockIdx.x * ROWS_PER_BLOCK + group;
  float4 sq[QPL];
#pragma unroll
  for (int k = 0; k < QPL; ++k) sq[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
  for (int i0 = 0; i0 < ROWS_PER_GROUP; i0 += RI) {
    int p[RI], end[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int pos = base + (i0 + i) * GROUPS;
      p[i] = end[i] = 0;
      if (pos < vend) {
        const int4 lr = __ldg(launch_rows + pos);
        p[i] = lr.x + slot;
        end[i] = lr.y;
      }
    }
    float4 acc[RI][QPL];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int k = 0; k < QPL; ++k) acc[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);
    // each lane reads the (pix, w) of its own U pairs of each row (the
    // lanes of a slot read the same ones), then gathers its quads of them
    for (;;) {
      bool more = false;
      int px[RI][U];
      float wq[RI][U];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int q = p[i] + S * u;
          px[i][u] = 0;
          wq[i][u] = 0.f;
          if (q < end[i]) {
            px[i][u] = __ldg(pix + q);
            wq[i][u] = __ldg(w + q);
            more = true;
          }
        }
      if (!more) break;
      float4 gv[RI][U][QPL];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (p[i] + S * u < end[i]) {
            const float4* gr = g + static_cast<long long>(px[i][u]) * Q + quad;
#pragma unroll
            for (int k = 0; k < QPL; ++k) gv[i][u][k] = __ldg(gr + k);
          }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (p[i] + S * u < end[i])
#pragma unroll
            for (int k = 0; k < QPL; ++k) axpy(acc[i][k], wq[i][u], gv[i][u][k]);
        p[i] += S * U;
      }
    }
    // the pair slots of a row meet in a fixed xor tree, then square
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int k = 0; k < QPL; ++k) {
#pragma unroll
        for (int off = NQ; off < GROUP; off <<= 1) {
          const float4 o = shfl_xor4(acc[i][k], off);
          acc[i][k].x = __fadd_rn(acc[i][k].x, o.x);
          acc[i][k].y = __fadd_rn(acc[i][k].y, o.y);
          acc[i][k].z = __fadd_rn(acc[i][k].z, o.z);
          acc[i][k].w = __fadd_rn(acc[i][k].w, o.w);
        }
        add_square(sq[k], acc[i][k]);
      }
  }
  __shared__ float part[GROUPS][MAXC];
  if (slot == 0) {
#pragma unroll
    for (int k = 0; k < QPL; ++k) {
      part[group][4 * (quad + k)] = sq[k].x;
      part[group][4 * (quad + k) + 1] = sq[k].y;
      part[group][4 * (quad + k) + 2] = sq[k].z;
      part[group][4 * (quad + k) + 3] = sq[k].w;
    }
  }
  block_partial(part, 4 * Q, n_chunks, partial, tickets, out);
}

// The scalar path, any channels <= CPL * GROUP: lane l owns channels
// l, l + GROUP, ...; a lane walks its rows' pairs one at a time.
template <int CPL>
__global__ void __launch_bounds__(BLOCK)
segsq_kernel(const int4* __restrict__ launch_rows,
             const int* __restrict__ view_ptr, const int* __restrict__ pix,
             const float* __restrict__ w, const float* __restrict__ g,
             int n_chunks, int channels, float* __restrict__ partial,
             unsigned* __restrict__ tickets, float* __restrict__ out) {
  const int v = blockIdx.y;
  const int lane = threadIdx.x % GROUP;
  const int group = threadIdx.x / GROUP;
  const int vend = __ldg(view_ptr + v + 1);
  const int base = __ldg(view_ptr + v) + blockIdx.x * ROWS_PER_BLOCK + group;
  float sq[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) sq[j] = 0.f;
  for (int i = 0; i < ROWS_PER_GROUP; ++i) {
    const int pos = base + i * GROUPS;
    if (pos >= vend) break;
    const int4 lr = __ldg(launch_rows + pos);
    float acc[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
    for (int p = lr.x; p < lr.y; ++p) {
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
  __shared__ float part[GROUPS][MAXC];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    if (lane + GROUP * j < MAXC) part[group][lane + GROUP * j] = sq[j];
  block_partial(part, channels, n_chunks, partial, tickets, out);
}

template <int CPL>
void launch_scalar(dim3 grid, cudaStream_t s, const int4* lr, const int* vp,
                   const int* px, const float* wt, const float* g,
                   int n_chunks, int channels, float* pt, unsigned* tk,
                   float* o) {
  segsq_kernel<CPL><<<grid, BLOCK, 0, s>>>(lr, vp, px, wt, g, n_chunks,
                                           channels, pt, tk, o);
}

}  // namespace

// out[n_views, channels] from the batched CSR plan walked through
// launch_rows (int4 [R], 16-byte aligned) and g[n_pixels, channels];
// partial is scratch of [n_views, n_chunks, channels] with n_chunks blocks
// of ROWS_PER_BLOCK rows covering the largest view; tickets is
// [n_views * TICKET_STRIDE] unsigned, zero before the launch and left zero
// after it. The vector path needs g 16-byte aligned. All pointers are
// device pointers; returns cudaGetLastError().
extern "C" int segsum_sq_launch(const void* launch_rows, const void* view_ptr,
                                const void* pix, const void* w, const void* g,
                                void* partial, void* tickets, void* out,
                                int n_views, int n_chunks, int channels,
                                void* stream) {
  if (n_views <= 0 || n_chunks <= 0 || n_views > 65535 || channels <= 0 ||
      channels > MAXC)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_chunks, n_views);
  const int4* lr = static_cast<const int4*>(launch_rows);
  const int* vp = static_cast<const int*>(view_ptr);
  const int* px = static_cast<const int*>(pix);
  const float* wt = static_cast<const float*>(w);
  const float4* g4 = static_cast<const float4*>(g);
  const float* gg = static_cast<const float*>(g);
  float* pt = static_cast<float*>(partial);
  unsigned* tk = static_cast<unsigned*>(tickets);
  float* o = static_cast<float*>(out);
  switch (channels) {
    case 4:
      segsq_vec_kernel<1><<<grid, BLOCK, 0, s>>>(lr, vp, px, wt, g4, n_chunks,
                                                 pt, tk, o);
      break;
    case 8:
      segsq_vec_kernel<2><<<grid, BLOCK, 0, s>>>(lr, vp, px, wt, g4, n_chunks,
                                                 pt, tk, o);
      break;
    case 16:
      segsq_vec_kernel<4><<<grid, BLOCK, 0, s>>>(lr, vp, px, wt, g4, n_chunks,
                                                 pt, tk, o);
      break;
    case 32:
      segsq_vec_kernel<8><<<grid, BLOCK, 0, s>>>(lr, vp, px, wt, g4, n_chunks,
                                                 pt, tk, o);
      break;
    default:
      if (channels <= GROUP)
        launch_scalar<1>(grid, s, lr, vp, px, wt, gg, n_chunks, channels, pt,
                         tk, o);
      else if (channels <= 2 * GROUP)
        launch_scalar<2>(grid, s, lr, vp, px, wt, gg, n_chunks, channels, pt,
                         tk, o);
      else if (channels <= 4 * GROUP)
        launch_scalar<4>(grid, s, lr, vp, px, wt, gg, n_chunks, channels, pt,
                         tk, o);
      else
        launch_scalar<8>(grid, s, lr, vp, px, wt, gg, n_chunks, channels, pt,
                         tk, o);
  }
  return static_cast<int>(cudaGetLastError());
}
