// The fused NeRF MLP for Hopper (sm_90a): K4 (forward) and K5 (its
// recompute backward).
//
// Replaces the TPU kernels of nerfail_tpu/ops/pallas/mlp_kernel.py:
//   K4  `_fwd_kernel` (body `_fwd_body`, driven by `_run_fwd`)
//   K5  `_bwd_kernel` (driven by `_fused_bwd`, the custom VJP)
//
// Function, per point: the Fourier encoding of the packed input row
// (xyz in lanes 0:3, view direction in 4:7; phases x·2^k are exact f32
// products, then sinf/cosf, channel order [x | sin cos at 2^0 | ...]),
// a D-layer ReLU trunk with the skip concat [x | h] after each layer in
// the skip mask, the feature layer, the view layer on [feature | enc_d]
// (ReLU), and the alpha and rgb heads added into disjoint columns of one
// 16-wide tile (rgb 0:3, alpha 3). Out f32 [n, 4]; the head biases are
// added by the wrapper. Matrix operands are bf16 (round to nearest even,
// as astype(bfloat16) rounds) and products accumulate in f32.
//
// Bound: operations. ≈ 1.19 MFLOP per point forward at 8×256 against 32 B
// in and 16 B out, far above the card's ≈ 295 FLOP/B ridge, so the
// design keeps everything but the input and output rows on chip:
//   * one block of 8 warps per tile of T = 64 points; the tile's encoding
//     and every activation live in shared memory as bf16 (≈ 118 KB at
//     8×256), and the products run on the tensor cores through WMMA
//     16×16×16 bf16 fragments with f32 accumulators. Each warp owns
//     16-column strips of a layer's output for all four 16-row tiles, so
//     a weight fragment is read (from L2: the 1.2 MB of bf16 weights stay
//     cached) once per 64 points;
//   * the epilogue (bias, ReLU, bf16 rounding) goes through a 1 KB
//     per-warp staging tile, because a fragment's element order is opaque.
// Simple first: no wgmma, TMA or warp specialisation yet, one block per
// SM, weight fragments loaded straight from global memory.
//
// K5 recomputes the forward of its tile and backpropagates. The TPU kernel
// keeps all D layer activations of a tile in VMEM (D·T·W·2 B); that is
// 288 KB at T = 64, more than a block's 227 KB, so here the recomputed
// activations go to a device-memory stash that the wrapper allocates, one
// region per block, while the f32 and bf16 gradients of the current layer,
// the input-gradient accumulators and the staging tiles stay in shared
// memory (≈ 156 KB at 8×256). The TPU kernel carries dW/db across its
// sequential grid; Hopper's blocks run in no order, so K5 runs a fixed
// grid of blocks that each walk tiles b, b+G, ... and accumulate their own
// f32 partials of every dW/db (no float atomics), and a second kernel adds
// the G partials in a fixed order. The result is bit-identical from launch
// to launch on one card. d_xin (through the encoding jacobian) is computed
// only when the caller passes its buffer, and layer 0's input gradient is
// skipped otherwise.
//
// Layouts (the Python wrapper packs the same; `nerf_mlp_sizes` lets it
// check): dims = {D, W, skip_mask, multires, multires_views, in_pad,
// vd_pad}. Weights, one flat bf16 buffer of row-major [K, N] matrices in
// the order W_0..W_{D-1} ([kin_i, W]; kin_0 = in_pad, kin_i = in_pad + W
// after a skip layer, else W), feature [W, W], views [W + vd_pad, W/2],
// alpha [W, 16], rgb [W/2, 16]. Biases, one flat f32 buffer: b_0..b_{D-1},
// feature_b [W], views_b [W/2]. dW/db come back in the same layouts, f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int T = 64;              // points per tile
constexpr int RT = T / 16;         // 16-row fragments per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int HEAD = 16;           // head columns: rgb 0:3, alpha 3
constexpr int MAXD = 16;

struct Dims {
  int D, W, skip, Lx, Ld, in_pad, vd_pad;
  int kin[MAXD + 1];               // width of layer i's input; kin[D] = trunk
  long long w_off[MAXD + 4];       // W_0..W_{D-1}, feature, views, alpha, rgb
  long long w_total, b_total;
  int kslot, kv, kmax;
};

__host__ __device__ inline bool is_skip(const Dims& d, int i) {
  return (d.skip >> i) & 1;
}

bool make_dims(const int* a, Dims* out) {
  Dims d;
  d.D = a[0]; d.W = a[1]; d.skip = a[2]; d.Lx = a[3]; d.Ld = a[4];
  d.in_pad = a[5]; d.vd_pad = a[6];
  if (d.D < 1 || d.D > MAXD || d.W < 32 || d.W > 256 || d.W % 32) return false;
  if (d.skip < 0 || (d.skip >> (d.D - 1)) != 0) return false;
  if (d.Lx < 0 || d.Ld < 0 || d.Lx > 24 || d.Ld > 24) return false;
  if (d.in_pad % 16 || d.in_pad < 3 * (1 + 2 * d.Lx)) return false;
  if (d.vd_pad % 16 || d.vd_pad < 3 * (1 + 2 * d.Ld)) return false;
  long long o = 0;
  for (int i = 0; i < d.D; ++i) {
    d.kin[i] = i == 0 ? d.in_pad : (is_skip(d, i - 1) ? d.in_pad + d.W : d.W);
    d.w_off[i] = o;
    o += static_cast<long long>(d.kin[i]) * d.W;
  }
  d.kin[d.D] = d.W;
  d.kv = d.W + d.vd_pad;
  d.w_off[d.D] = o;     o += static_cast<long long>(d.W) * d.W;
  d.w_off[d.D + 1] = o; o += static_cast<long long>(d.kv) * (d.W / 2);
  d.w_off[d.D + 2] = o; o += static_cast<long long>(d.W) * HEAD;
  d.w_off[d.D + 3] = o; o += static_cast<long long>(d.W / 2) * HEAD;
  d.w_total = o;
  d.b_total = static_cast<long long>(d.D + 1) * d.W + d.W / 2;
  d.kslot = d.in_pad + d.W;
  d.kmax = d.kslot > d.kv ? d.kslot : d.kv;
  *out = d;
  return true;
}

// bf16 elements of one block's activation stash in K5
long long stash_elems(const Dims& d) {
  return static_cast<long long>(T) *
         ((d.D + 1) * d.kslot + d.vd_pad + d.kv + d.W / 2);
}

size_t align128(size_t x) { return (x + 127) & ~static_cast<size_t>(127); }

size_t fwd_smem(const Dims& d) {
  return align128(WARPS * 256 * 4) + align128(T * 8 * 4) +
         align128(T * d.in_pad * 2) + align128(T * d.vd_pad * 2) +
         2 * align128(static_cast<size_t>(T) * d.kmax * 2) +
         align128(T * (d.W / 2) * 2);
}

size_t bwd_smem(const Dims& d) {
  return align128(WARPS * 256 * 4) + align128(T * 8 * 4) +
         align128(static_cast<size_t>(T) * d.kmax * 4) +
         align128(static_cast<size_t>(T) * d.kmax * 2) +
         align128(T * HEAD * 2) + align128(T * d.in_pad * 4) +
         align128(T * d.vd_pad * 4);
}

// bump allocator over dynamic shared memory (128-byte aligned regions)
struct Carve {
  unsigned char* p;
  template <typename X>
  __device__ X* take(size_t n) {
    X* r = reinterpret_cast<X*>(p);
    p += (n * sizeof(X) + 127) & ~static_cast<size_t>(127);
    return r;
  }
};

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Encoding channel c of one 3-vector: [x | sin(x·2^0) cos(x·2^0) | ...],
// zero in the padding. x·2^k is exact in f32.
__device__ __forceinline__ float enc_value(const float* x3, int c, int L) {
  if (c < 3) return x3[c];
  const int cp = c - 3, k = cp / 6, r = cp % 6;
  if (k >= L) return 0.f;
  const float ph = x3[r % 3] * static_cast<float>(1u << k);
  return r < 3 ? sinf(ph) : cosf(ph);
}

// d enc_c / d x_dim(c), and the frequency of channel c (0 for padding)
__device__ __forceinline__ float enc_jac(const float* x3, int c, int L,
                                         float* freq, int* dim) {
  if (c < 3) { *freq = 1.f; *dim = c; return 1.f; }
  const int cp = c - 3, k = cp / 6, r = cp % 6;
  *dim = r % 3;
  if (k >= L) { *freq = 0.f; return 0.f; }
  *freq = static_cast<float>(1u << k);
  const float ph = x3[r % 3] * *freq;
  return r < 3 ? cosf(ph) : -sinf(ph);
}

template <typename L>
__device__ __forceinline__ const bf16* at(const bf16* base, int ld, int r, int c) {
  if constexpr (std::is_same<L, wmma::row_major>::value)
    return base + static_cast<long long>(r) * ld + c;
  else
    return base + static_cast<long long>(c) * ld + r;
}

// out[T, N] = A[T, K] @ B[K, N] (+ A2[T, K2] @ B2[K2, N]), A row-major
// bf16; B's logical [K, N] is read with layout LB (col_major reads a
// row-major [N, K] matrix transposed). epi(row, col, value) runs on every
// f32 output element. Warp w owns column strips w, w + 8, ... for all RT
// row fragments.
template <typename LB, typename LB2 = wmma::row_major, typename Epi>
__device__ void gemm_rows(const bf16* A, int lda, const bf16* B, int ldb, int K,
                          const bf16* A2, int lda2, const bf16* B2, int ldb2,
                          int K2, int N, float* stage, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = stage + warp * 256;
  for (int tc = warp; tc < N / 16; tc += WARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) wmma::fill_fragment(acc[r], 0.f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
      wmma::load_matrix_sync(fb, at<LB>(B, ldb, k, tc * 16), ldb);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, A + static_cast<long long>(r * 16) * lda + k, lda);
        wmma::mma_sync(acc[r], fa, fb, acc[r]);
      }
    }
    for (int k = 0; k < K2; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB2> fb;
      wmma::load_matrix_sync(fb, at<LB2>(B2, ldb2, k, tc * 16), ldb2);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, A2 + static_cast<long long>(r * 16) * lda2 + k, lda2);
        wmma::mma_sync(acc[r], fa, fb, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      wmma::store_matrix_sync(st, acc[r], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) epi(r * 16 + e / 16, tc * 16 + e % 16, st[e]);
      __syncwarp();
    }
  }
}

// out[M, N] (f32, row-major, ld N) += A[T, M]ᵀ @ B[T, N]: the weight
// gradient of one tile, added into this block's own partial.
__device__ void gemm_wgrad(const bf16* A, int lda, int M, const bf16* B, int ldb,
                           int N, float* out) {
  const int warp = threadIdx.x >> 5;
  const int tn_count = N / 16;
  const int tiles = (M / 16) * tn_count;
  for (int t = warp; t < tiles; t += WARPS) {
    const int tm = t / tn_count, tn = t % tn_count;
    float* o = out + static_cast<long long>(tm * 16) * N + tn * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, o, N, wmma::mem_row_major);
#pragma unroll
    for (int k = 0; k < T; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, A + static_cast<long long>(k) * lda + tm * 16, lda);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, B + static_cast<long long>(k) * ldb + tn * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(o, acc, N, wmma::mem_row_major);
  }
}

// dst[c] += Σ_r src[r·ld + c] for c < N, rows in order
__device__ void colsum_add(const float* src, int ld, int N, float* dst) {
  for (int c = threadIdx.x; c < N; c += THREADS) {
    float s = 0.f;
    for (int r = 0; r < T; ++r) s = __fadd_rn(s, src[r * ld + c]);
    dst[c] = __fadd_rn(dst[c], s);
  }
}

struct Bufs {
  bf16* act[MAXD + 1];   // act[i]: input of layer i [T, kin[i]]; act[D]: trunk
  bf16* encd;            // [T, vd_pad]
  bf16* hvin;            // [T, W + vd_pad]
  bf16* hv;              // [T, W/2]
};

// Encoding and MLP of one tile. xs: the tile's packed input rows [T, 8].
// out (optional): [T, 4] raw rgb + sigma without the head biases.
// z0 (optional): [T, W] layer 0's f32 pre-activation (a probe for checks).
__device__ void forward_tile(const Dims& d, const float* xs, const bf16* w,
                             const float* b, const Bufs& B, float* stage,
                             float* out, float* z0) {
  const int W = d.W, W2 = d.W / 2;
  for (int e = threadIdx.x; e < T * d.in_pad; e += THREADS)
    B.act[0][e] = to_bf16(enc_value(xs + (e / d.in_pad) * 8, e % d.in_pad, d.Lx));
  for (int e = threadIdx.x; e < T * d.vd_pad; e += THREADS)
    B.encd[e] = to_bf16(enc_value(xs + (e / d.vd_pad) * 8 + 4, e % d.vd_pad, d.Ld));
  __syncthreads();
  for (int i = 0; i < d.D; ++i) {
    bf16* dst = B.act[i + 1];
    const int ldd = d.kin[i + 1];
    const bool sk = is_skip(d, i);
    const int off = sk ? d.in_pad : 0;
    const float* bias = b + static_cast<long long>(i) * W;
    float* zp = i == 0 ? z0 : nullptr;
    gemm_rows<wmma::row_major>(
        B.act[i], d.kin[i], w + d.w_off[i], W, d.kin[i], nullptr, 0, nullptr,
        0, 0, W, stage, [&](int r, int c, float v) {
          v = __fadd_rn(v, bias[c]);
          if (zp != nullptr) zp[r * W + c] = v;
          dst[r * ldd + off + c] = to_bf16(fmaxf(v, 0.f));
        });
    if (sk)
      for (int e = threadIdx.x; e < T * d.in_pad; e += THREADS)
        dst[(e / d.in_pad) * ldd + e % d.in_pad] = B.act[0][e];
    __syncthreads();
  }
  const bf16* trunk = B.act[d.D];
  const float* bf = b + static_cast<long long>(d.D) * W;
  const float* bv = bf + W;
  bf16* hvin = B.hvin;
  bf16* hv = B.hv;
  const int kv = d.kv;
  gemm_rows<wmma::row_major>(
      trunk, W, w + d.w_off[d.D], W, W, nullptr, 0, nullptr, 0, 0, W, stage,
      [&](int r, int c, float v) { hvin[r * kv + c] = to_bf16(__fadd_rn(v, bf[c])); });
  for (int e = threadIdx.x; e < T * d.vd_pad; e += THREADS)
    hvin[(e / d.vd_pad) * kv + W + e % d.vd_pad] = B.encd[e];
  __syncthreads();
  gemm_rows<wmma::row_major>(
      hvin, kv, w + d.w_off[d.D + 1], W2, kv, nullptr, 0, nullptr, 0, 0, W2,
      stage, [&](int r, int c, float v) {
        hv[r * W2 + c] = to_bf16(fmaxf(__fadd_rn(v, bv[c]), 0.f));
      });
  __syncthreads();
  if (out != nullptr) {
    gemm_rows<wmma::row_major, wmma::row_major>(
        trunk, W, w + d.w_off[d.D + 2], HEAD, W, hv, W2, w + d.w_off[d.D + 3],
        HEAD, W2, HEAD, stage, [&](int r, int c, float v) {
          if (c < 4) out[r * 4 + c] = v;
        });
  }
  __syncthreads();
}

__device__ void load_rows(const float* xin, long long row0, float* xs) {
  for (int e = threadIdx.x; e < T * 8; e += THREADS) xs[e] = xin[row0 * 8 + e];
}

__global__ void __launch_bounds__(THREADS)
mlp_fwd_kernel(Dims d, const float* __restrict__ xin, const bf16* __restrict__ w,
               const float* __restrict__ b, float* __restrict__ out,
               float* __restrict__ z0) {
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* stage = cv.take<float>(WARPS * 256);
  float* xs = cv.take<float>(T * 8);
  Bufs B;
  B.act[0] = cv.take<bf16>(T * d.in_pad);
  B.encd = cv.take<bf16>(T * d.vd_pad);
  bf16* buf[2] = {cv.take<bf16>(static_cast<size_t>(T) * d.kmax),
                  cv.take<bf16>(static_cast<size_t>(T) * d.kmax)};
  B.hv = cv.take<bf16>(T * (d.W / 2));
  for (int i = 1; i <= d.D; ++i) B.act[i] = buf[(i - 1) & 1];
  B.hvin = buf[d.D & 1];            // the buffer that does not hold the trunk
  const long long row0 = static_cast<long long>(blockIdx.x) * T;
  load_rows(xin, row0, xs);
  __syncthreads();
  forward_tile(d, xs, w, b, B, stage, out + row0 * 4,
               z0 == nullptr ? nullptr : z0 + row0 * d.W);
}

__global__ void __launch_bounds__(THREADS)
mlp_bwd_kernel(Dims d, const float* __restrict__ xin, const bf16* __restrict__ w,
               const float* __restrict__ b, const float* __restrict__ g,
               float* __restrict__ d_xin, bf16* __restrict__ stash,
               float* __restrict__ dw_part, float* __restrict__ db_part,
               int n_tiles, long long stash_stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* stage = cv.take<float>(WARPS * 256);
  float* xs = cv.take<float>(T * 8);
  float* gF = cv.take<float>(static_cast<size_t>(T) * d.kmax);   // f32 grads
  bf16* gB = cv.take<bf16>(static_cast<size_t>(T) * d.kmax);     // bf16 operand
  bf16* gH = cv.take<bf16>(T * HEAD);                            // head cotangent
  float* dx = cv.take<float>(T * d.in_pad);                      // d enc_x (skips)
  float* denc = cv.take<float>(T * d.vd_pad);                    // d enc_d

  const int D = d.D, W = d.W, W2 = d.W / 2, kv = d.kv;
  bf16* base = stash + blockIdx.x * stash_stride;
  Bufs B;
  for (int i = 0; i <= D; ++i) B.act[i] = base + static_cast<long long>(i) * T * d.kslot;
  B.encd = base + static_cast<long long>(D + 1) * T * d.kslot;
  B.hvin = B.encd + T * d.vd_pad;
  B.hv = B.hvin + T * kv;
  float* dwp = dw_part + blockIdx.x * d.w_total;
  float* dbp = db_part + blockIdx.x * d.b_total;
  const bool in_grads = d_xin != nullptr;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * T;
    load_rows(xin, row0, xs);
    __syncthreads();
    forward_tile(d, xs, w, b, B, stage, nullptr, nullptr);
    const bf16* trunk = B.act[D];
    const bf16* hv = B.hv;
    for (int e = threadIdx.x; e < T * HEAD; e += THREADS) {
      const int r = e / HEAD, c = e % HEAD;
      gH[e] = to_bf16(c < 4 ? g[(row0 + r) * 4 + c] : 0.f);
    }
    if (in_grads)
      for (int e = threadIdx.x; e < T * d.in_pad; e += THREADS) dx[e] = 0.f;
    __syncthreads();

    // heads: out = trunk @ Wa + hv @ Wr
    gemm_wgrad(hv, W2, W2, gH, HEAD, HEAD, dwp + d.w_off[D + 3]);
    gemm_wgrad(trunk, W, W, gH, HEAD, HEAD, dwp + d.w_off[D + 2]);
    gemm_rows<wmma::col_major>(
        gH, HEAD, w + d.w_off[D + 3], HEAD, HEAD, nullptr, 0, nullptr, 0, 0,
        W2, stage, [&](int r, int c, float v) {
          gF[r * W2 + c] = to_f32(hv[r * W2 + c]) > 0.f ? v : 0.f;
        });
    __syncthreads();
    colsum_add(gF, W2, W2, dbp + static_cast<long long>(D + 1) * W);
    for (int e = threadIdx.x; e < T * W2; e += THREADS) gB[e] = to_bf16(gF[e]);
    __syncthreads();

    // view layer on [feature | enc_d]
    gemm_wgrad(B.hvin, kv, kv, gB, W2, W2, dwp + d.w_off[D + 1]);
    gemm_rows<wmma::col_major>(
        gB, W2, w + d.w_off[D + 1], W2, W2, nullptr, 0, nullptr, 0, 0, kv,
        stage, [&](int r, int c, float v) { gF[r * kv + c] = v; });
    __syncthreads();
    if (in_grads)
      for (int e = threadIdx.x; e < T * d.vd_pad; e += THREADS)
        denc[e] = gF[(e / d.vd_pad) * kv + W + e % d.vd_pad];
    colsum_add(gF, kv, W, dbp + static_cast<long long>(D) * W);
    __syncthreads();
    for (int e = threadIdx.x; e < T * W; e += THREADS)
      gB[e] = to_bf16(gF[(e / W) * kv + e % W]);
    __syncthreads();

    // feature layer and the alpha head into d_trunk
    gemm_wgrad(trunk, W, W, gB, W, W, dwp + d.w_off[D]);
    gemm_rows<wmma::col_major, wmma::col_major>(
        gB, W, w + d.w_off[D], W, W, gH, HEAD, w + d.w_off[D + 2], HEAD, HEAD,
        W, stage, [&](int r, int c, float v) { gF[r * W + c] = v; });
    __syncthreads();

    // trunk, last layer first; gF holds d(input of layer i+1), ld kin[i+1]
    for (int i = D - 1; i >= 0; --i) {
      const int ldh = d.kin[i + 1];
      const bool sk = is_skip(d, i);
      const int off = sk ? d.in_pad : 0;
      const bf16* outs = B.act[i + 1];
      if (sk && in_grads)
        for (int e = threadIdx.x; e < T * d.in_pad; e += THREADS)
          dx[e] = __fadd_rn(dx[e], gF[(e / d.in_pad) * ldh + e % d.in_pad]);
      for (int e = threadIdx.x; e < T * W; e += THREADS) {
        const int r = e / W, c = e % W;
        const int j = r * ldh + off + c;
        const float v = to_f32(outs[j]) > 0.f ? gF[j] : 0.f;
        gF[j] = v;
        gB[e] = to_bf16(v);
      }
      __syncthreads();
      colsum_add(gF + off, ldh, W, dbp + static_cast<long long>(i) * W);
      __syncthreads();
      gemm_wgrad(B.act[i], d.kin[i], d.kin[i], gB, W, W, dwp + d.w_off[i]);
      if (i > 0 || in_grads) {
        const int ldo = d.kin[i];
        gemm_rows<wmma::col_major>(
            gB, W, w + d.w_off[i], W, W, nullptr, 0, nullptr, 0, 0, ldo,
            stage, [&](int r, int c, float v) { gF[r * ldo + c] = v; });
      }
      __syncthreads();
    }

    // encoding jacobian: d_xin[r, j] = Σ_c jac_c · d enc_c · freq_c
    if (in_grads) {
      for (int e = threadIdx.x; e < T * 8; e += THREADS) {
        const int r = e / 8, lane = e % 8;
        float s = 0.f;
        if (lane < 3) {
          for (int c = 0; c < d.in_pad; ++c) {
            float f; int dim;
            const float jac = enc_jac(xs + r * 8, c, d.Lx, &f, &dim);
            if (dim != lane || f == 0.f) continue;
            const float dxc = __fadd_rn(dx[r * d.in_pad + c], gF[r * d.in_pad + c]);
            s = __fadd_rn(s, __fmul_rn(__fmul_rn(jac, dxc), f));
          }
        } else if (lane >= 4 && lane < 7) {
          for (int c = 0; c < d.vd_pad; ++c) {
            float f; int dim;
            const float jac = enc_jac(xs + r * 8 + 4, c, d.Ld, &f, &dim);
            if (dim != lane - 4 || f == 0.f) continue;
            s = __fadd_rn(s, __fmul_rn(__fmul_rn(jac, denc[r * d.vd_pad + c]), f));
          }
        }
        d_xin[(row0 + r) * 8 + lane] = s;
      }
    }
    __syncthreads();
  }
}

// out[j] = Σ_p part[p·len + j], p in order
__global__ void reduce_parts_kernel(const float* __restrict__ part, int n_part,
                                    long long len, float* __restrict__ out) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= len) return;
  float s = 0.f;
  for (int p = 0; p < n_part; ++p) s = __fadd_rn(s, part[p * len + j]);
  out[j] = s;
}

int launch_reduce(const float* part, int n_part, long long len, float* out,
                  cudaStream_t s) {
  const int threads = 256;
  const long long blocks = (len + threads - 1) / threads;
  reduce_parts_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      part, n_part, len, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sizes[0] = flat weight elements, [1] = flat bias elements, [2] = bf16
// stash elements per K5 block, [3] = K4 shared bytes, [4] = K5 shared
// bytes. Returns 0, or cudaErrorInvalidValue for dims the kernels refuse.
extern "C" int nerf_mlp_sizes(const int* dims, long long* sizes) {
  Dims d;
  if (!make_dims(dims, &d)) return static_cast<int>(cudaErrorInvalidValue);
  sizes[0] = d.w_total;
  sizes[1] = d.b_total;
  sizes[2] = stash_elems(d);
  sizes[3] = static_cast<long long>(fwd_smem(d));
  sizes[4] = static_cast<long long>(bwd_smem(d));
  return 0;
}

// K4: out [n, 4] from xin [n, 8]; n a multiple of 64. z0 may be null.
extern "C" int nerf_mlp_fwd_launch(const int* dims, const void* xin,
                                   const void* w, const void* b, void* out,
                                   void* z0, int n, void* stream) {
  Dims d;
  if (!make_dims(dims, &d) || n <= 0 || n % T)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_fwd_kernel<<<n / T, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      d, static_cast<const float*>(xin), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<float*>(out),
      static_cast<float*>(z0));
  return static_cast<int>(cudaGetLastError());
}

// K5: dw [w_total], db [b_total] (and d_xin [n, 8] unless null) from
// g [n, 4]. stash: n_blocks · sizes[2] bf16; dw_part [n_blocks, w_total]
// and db_part [n_blocks, b_total] f32, zero on entry.
extern "C" int nerf_mlp_bwd_launch(const int* dims, const void* xin,
                                   const void* w, const void* b, const void* g,
                                   void* d_xin, void* stash, void* dw_part,
                                   void* db_part, void* dw, void* db, int n,
                                   int n_blocks, void* stream) {
  Dims d;
  if (!make_dims(dims, &d) || n <= 0 || n % T || n_blocks <= 0 ||
      n_blocks > n / T)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_bwd_kernel<<<n_blocks, THREADS, smem, s>>>(
      d, static_cast<const float*>(xin), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<const float*>(g),
      static_cast<float*>(d_xin), static_cast<bf16*>(stash),
      static_cast<float*>(dw_part), static_cast<float*>(db_part), n / T,
      stash_elems(d));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int st = launch_reduce(static_cast<const float*>(dw_part), n_blocks,
                         d.w_total, static_cast<float*>(dw), s);
  if (st != 0) return st;
  return launch_reduce(static_cast<const float*>(db_part), n_blocks,
                       d.b_total, static_cast<float*>(db), s);
}
