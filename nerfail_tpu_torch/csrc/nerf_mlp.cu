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
// in and 16 B out, far above the card's ≈ 295 FLOP/B ridge, so both
// kernels keep everything but the input and output rows on chip.
//
// K4, `mlp_fwd_ws_kernel<W>` (the section at the end of this file), is
// persistent and warp-specialised on wgmma: one block per SM walks tiles
// of 128 points, two consumer warpgroups of 64 rows each keep their
// activations in shared memory, and a producer streams the weights
// through a ring of shared-memory stages by bulk copies, so each weight
// byte read from L2 serves 128 points.
//
// K5a's forward (`forward_tile`), per tile:
//   * one block of 8 warps per tile of T = 64 points, two blocks per SM;
//     the tile's encoding and every activation live in shared memory as
//     bf16 (≈ 90 KB at 8×256), their rows skewed by 16 bytes so that the
//     rows of an ldmatrix fall into distinct banks. A layer after a skip
//     takes [enc_x | h] as two operands, and the view layer [feature |
//     enc_d], so no activation tile is wider than W;
//   * the products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulators). Each warp owns 16-column strips of a layer's
//     output for all four 16-row tiles, so a weight fragment is read (from
//     L2: the weights stay cached) once per 64 points. The wrapper packs
//     the weights in fragment order, so a fragment is one 16-byte load per
//     lane, and four are in flight while the products of the current one
//     run;
//   * the epilogue (bias, ReLU, bf16 rounding, and the ReLU mask bits)
//     reads the accumulators in place.
// Not yet in this per-tile core (K5a): wgmma, weights staged in shared
// memory, warp specialisation.
//
// K5 is two kernels. The TPU kernel carries dW/db across its sequential
// grid; Hopper's blocks run in no order, and a block that owned a partial
// of every dW would read and write it (≈ 4.8 MB at 8×256) on every tile.
// So the weight gradients leave the per-tile loop:
//   * K5a, `mlp_bwd_pass_kernel`: a fixed grid of blocks walks tiles b,
//     b+G, ...; each recomputes its tile's forward and backpropagates
//     through heads, view layer, feature layer and trunk (d_xin through
//     the encoding jacobian only when the caller passes its buffer). Its
//     forward is `forward_tile`, in shared memory, and it copies every dW operand
//     as it is formed to a per-point stash in device memory, in
//     planar layouts: the bf16 input A_j of each layer as [n, rows_j] and
//     the bf16 dZ_j as [n, cols_j] (trunk layers, feature, views, and the
//     16-wide head cotangent). The forward also keeps every ReLU mask as
//     one bit per element, and each
//     layer's product applies the mask of the layer below in its epilogue,
//     rounds that layer's dZ to bf16 (the next product's operand) and sums
//     its f32 columns into db. Masks, two bf16 dZ tiles (in the space of
//     the forward's tiles) and the input-gradient tiles stay in shared
//     memory (≈ 112 KB at 8×256, two blocks per SM), so the backward reads
//     nothing back from device memory. The stash is written with streaming
//     stores (evict first), which keep the weights in L2. db's sums go to
//     one f32 partial per block, added in a fixed order afterwards;
//   * K5b, `mlp_wgrad_kernel`: dW_j = A_jᵀ · dZ_j, the sum over the n
//     points, on wgmma. Each block owns one 128-row tile of one dW_j (all
//     its columns; two warpgroups of 64 rows share its dZ slice) and one
//     fixed chunk of points (split-K). A 4-stage ring of cp.async copies
//     brings 32-point slices of A and dZ into shared memory in wgmma's
//     MN-major core-matrix layout; the f32 accumulators stay in registers
//     across the chunk and are written once, to the split's partial, and
//     a fixed-order pass adds the splits. Each row tile of a dW reads
//     that layer's dZ slice again, so tiles are 128 rows (not wgmma's
//     64) and blocks of one split run together: the repeated reads of a
//     dZ chunk then come from L2.
// No float atomics: the result is bit-identical from launch to launch on
// one card, and dW/db do not depend on whether d_xin is asked for.
//
// Bytes of the stash at 8×256: per point 2 592 bf16 of A (5.2 KB) and
// 2 448 of dZ (4.9 KB), written once by K5a and read at least once by
// K5b: ≈ 5.3 GB at 262 144 points, ≥ 1.6 ms at 3.35 TB/s, the floor of
// this design (above the 0.94 ms operations bound). It replaces ≈ 20 GB
// of per-tile partial round trips, and costs ≈ 2.6 GB of device memory at
// 262 144 points.
//
// Layouts (the Python wrapper packs the same; `nerf_mlp_sizes` lets it
// check): dims = {D, W, skip_mask, multires, multires_views, in_pad,
// vd_pad}. Weights, one flat bf16 buffer of row-major [K, N] matrices in
// the order W_0..W_{D-1} ([kin_i, W]; kin_0 = in_pad, kin_i = in_pad + W
// after a skip layer, else W), feature [W, W], views [W + vd_pad, W/2],
// alpha [W, 16], rgb [W/2, 16]. Biases, one flat f32 buffer: b_0..b_{D-1},
// feature_b [W], views_b [W/2]. dW/db come back in the same layouts, f32.
// The stash, bf16, plane after plane, each [n, width]: A planes for the
// inputs of W_0..W_{D-1} (kin_i), the trunk (W), [feature | enc_d]
// (W + vd_pad) and hv (W/2); then dZ planes for W_0..W_{D-1} (W), feature
// (W), views (W/2) and the heads (16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

typedef __nv_bfloat16 bf16;

namespace {

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, smem) once per
// kernel, device and larger size, not on every launch: after the first,
// uncaptured call a launch entry point changes no kernel attribute, so a
// train step captured in a CUDA graph holds nothing but its launches.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<size_t>* allowed, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[dev].load() >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) allowed[dev].store(smem);
  return err;
}

constexpr int T = 64;              // points per tile
constexpr int RT = T / 16;         // 16-row fragments per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int HEAD = 16;           // head columns: rgb 0:3, alpha 3
constexpr int LDH = HEAD + 8;      // row stride of the head cotangent tile
constexpr int MAXD = 16;

struct Dims {
  int D, W, skip, Lx, Ld, in_pad, vd_pad;
  int kin[MAXD + 1];               // width of layer i's input; kin[D] = trunk
  long long w_off[MAXD + 4];       // W_0..W_{D-1}, feature, views, alpha, rgb
  long long w_total, b_total;
  int kv;
  // row strides (bf16) of the shared-memory tiles, each skewed by 16 bytes
  // so that the rows of a fragment fall into distinct banks: enc_x, enc_d,
  // the W-wide activation and dZ tiles, hv
  int lx, lv, lbuf, lh;
  // the per-point stash: first column of each A plane (inputs of
  // W_0..W_{D-1}, trunk, [feature | enc_d], hv) and of each dZ plane
  // (W_0..W_{D-1}, feature, views, heads), in bf16 elements per point
  int a_col[MAXD + 3], z_col[MAXD + 3], stash_cols;
  // dW_j for j = 0..D+3: rows, columns, its A plane and its dZ plane
  int mk[MAXD + 4], mn[MAXD + 4], ma[MAXD + 4], mz[MAXD + 4];
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
  d.lx = d.in_pad + 8;
  d.lv = d.vd_pad + 8;
  d.lbuf = d.W + 8;
  d.lh = d.W / 2 + 8;
  const int D = d.D;
  int col = 0;
  for (int p = 0; p < D + 3; ++p) {
    d.a_col[p] = col;
    col += p < D ? d.kin[p] : p == D ? d.W : p == D + 1 ? d.kv : d.W / 2;
  }
  for (int p = 0; p < D + 3; ++p) {
    d.z_col[p] = col;
    col += p <= D ? d.W : p == D + 1 ? d.W / 2 : HEAD;
  }
  d.stash_cols = col;
  for (int j = 0; j < D + 4; ++j) {
    d.mk[j] = j < D ? d.kin[j] : j == D + 1 ? d.kv : j == D + 3 ? d.W / 2 : d.W;
    d.mn[j] = j <= D ? d.W : j == D + 1 ? d.W / 2 : HEAD;
    d.ma[j] = j < D + 2 ? j : j == D + 2 ? D : D + 2;
    d.mz[j] = j < D + 3 ? j : D + 2;
  }
  *out = d;
  return true;
}

size_t align128(size_t x) { return (x + 127) & ~static_cast<size_t>(127); }

// the forward's tiles: enc_d, enc_x (shared with hv), two activation
// buffers
size_t fwd_bufs_smem(const Dims& d) {
  return align128(T * d.lv * 2) + align128(T * (d.lx > d.lh ? d.lx : d.lh) * 2) +
         2 * align128(static_cast<size_t>(T) * d.lbuf * 2);
}

// 16-bit words of K5a's ReLU masks: D trunk layers [T, W] and hv [T, W/2]
__host__ __device__ inline size_t mask_words(const Dims& d) {
  return static_cast<size_t>(T) * (d.D * d.W + d.W / 2) / 16;
}

// K5a: the forward's tiles, then in their space two bf16 dZ tiles, the
// head cotangent and the f32 input-gradient tiles
size_t bwd_smem(const Dims& d) {
  const size_t grads = 2 * align128(static_cast<size_t>(T) * d.lbuf * 2) +
                       align128(T * LDH * 2) + align128(T * d.in_pad * 4) +
                       align128(T * d.vd_pad * 4);
  const size_t fwd = fwd_bufs_smem(d);
  return align128(T * 8 * 4) + align128(mask_words(d) * 2) +
         (grads > fwd ? grads : fwd);
}

// K5b: rows of dW per block (two warpgroups of 64), points per ring
// stage, stages, threads, and the descriptor offsets (bytes) of its
// MN-major A operand: LBO between core matrices along K (points), SBO
// along M. dZ's are N · 16 and 128.
constexpr int BM = 128;
constexpr int KC = 32;
constexpr int STAGES = 4;
constexpr int WG_THREADS = 256;
constexpr unsigned A_LBO = BM * 16, A_SBO = 128;

size_t wgrad_smem() {
  return static_cast<size_t>(STAGES) * KC / 8 * (BM * 16 + 256 * 16);
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

// Matrix products of a tile run on mma.sync.m16n8k16 (bf16 in, f32 out),
// whose register layouts PTX documents; for lane l, g = l / 4, t = l % 4:
//   A (16×16, from shared memory by ldmatrix.x4): rows g, g + 8, columns
//     2t, 2t + 1, 2t + 8, 2t + 9;
//   B (16×8): column g, rows 2t, 2t + 1, 2t + 8, 2t + 9;
//   C (16×8, f32): rows g, g + 8, columns 2t, 2t + 1.
// The weights come packed by the wrapper in that order (`pack_fragments`
// in ops/cuda/mlp_kernel.py): a logical [K, N] operand as [K/16][N/16]
// fragments of 32 lanes × 8 bf16, lane (g, t) holding rows 2t + {0, 1, 8,
// 9} of column g, then of column 8 + g. A 16×16 weight fragment is then one
// 16-byte load per lane, and the epilogue reads the accumulators in place.

__device__ __forceinline__ void ldmatrix_x4(unsigned* a, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[r] += A[16r.., K] @ B[K, 16tc..] for the RT row fragments; A
// row-major bf16 in shared memory, B packed ([K/16][nt] fragments) in
// device memory, read through L2. PF weight fragments are in flight: the
// one for k-step ks + PF is loaded while the products of k-step ks run.
__device__ __forceinline__ void mma_strip(float (*acc)[8], const bf16* A, int lda,
                                          const bf16* B, int nt, int K, int tc) {
  constexpr int PF = 4;
  const int lane = threadIdx.x & 31, nk = K / 16;
  const uint4* bq = reinterpret_cast<const uint4*>(B) + tc * 32 + lane;
  const int kstep = nt * 32;
  uint4 fb[PF];
#pragma unroll
  for (int p = 0; p < PF; ++p)
    if (p < nk) fb[p] = __ldg(bq + p * kstep);
  const bf16* arow = A + (lane & 15) * lda + (lane >> 4) * 8;
  for (int k0 = 0; k0 < nk; k0 += PF) {
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      const int ks = k0 + p;
      if (ks < nk) {
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          unsigned a[4];
          ldmatrix_x4(a, arow + r * 16 * lda + ks * 16);
          mma_bf16(acc[r], a, fb[p].x, fb[p].y);
          mma_bf16(acc[r] + 4, a, fb[p].z, fb[p].w);
        }
        if (ks + PF < nk) fb[p] = __ldg(bq + (ks + PF) * kstep);
      }
    }
  }
}

// out[T, N] = A[T, K] @ B[K, N] (+ A2[T, K2] @ B2[K2, N]), A and A2 in
// shared memory (row strides lda, lda2 skewed by 16 B so that the eight
// rows of an ldmatrix fall into distinct banks), B and B2 packed. Warp w
// owns column strips w, w + 8, ... for all RT row fragments, and
// epi(row, col, value) runs on every f32 output element straight from the
// accumulators and returns a value s. When `mask` is given, s > 0 is kept
// as a bit per element: bit c % 16 of word row·N/16 + c/16 (the four lanes
// of a row group OR their bits together). When `colsum` is given, the s of
// columns cs_lo <= c < cs_hi are summed over the T rows in a fixed order
// (each lane over its rows, then a fixed shuffle tree over the lanes of a
// column) and added to colsum[c - cs_lo]. The warp that owns a column is
// the only writer of its sum: no atomics.
template <typename Epi>
__device__ void gemm_rows(const bf16* A, int lda, const bf16* B, int K,
                          const bf16* A2, int lda2, const bf16* B2, int K2,
                          int N, unsigned short* mask, float* colsum, int cs_lo,
                          int cs_hi, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int tc = warp; tc < N / 16; tc += WARPS) {
    float acc[RT][8];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    mma_strip(acc, A, lda, B, N / 16, K, tc);
    if (K2 > 0) mma_strip(acc, A2, lda2, B2, N / 16, K2, tc);
    float cs[4] = {0.f, 0.f, 0.f, 0.f};  // columns 2t + {0, 1, 8, 9}
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      unsigned lo = 0, hi = 0;           // bits of rows g and g + 8
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int row = r * 16 + g + ((q >> 1) & 1) * 8;
        const int c = 2 * t + (q & 1) + (q >> 2) * 8;
        const float v = epi(row, tc * 16 + c, acc[r][q]);
        const unsigned on = v > 0.f ? 1u : 0u;
        if (q & 2) hi |= on << c; else lo |= on << c;
        const int j = (q & 1) + 2 * (q >> 2);
        cs[j] = __fadd_rn(cs[j], v);
      }
      if (mask != nullptr) {
        lo |= __shfl_xor_sync(0xffffffffu, lo, 1);
        lo |= __shfl_xor_sync(0xffffffffu, lo, 2);
        hi |= __shfl_xor_sync(0xffffffffu, hi, 1);
        hi |= __shfl_xor_sync(0xffffffffu, hi, 2);
        if (t == 0) {
          mask[(r * 16 + g) * (N / 16) + tc] = static_cast<unsigned short>(lo);
          mask[(r * 16 + g + 8) * (N / 16) + tc] = static_cast<unsigned short>(hi);
        }
      }
    }
    if (colsum != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = cs[j];
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
        const int c = tc * 16 + 2 * t + (j & 1) + 8 * (j >> 1);
        if (g == 0 && c >= cs_lo && c < cs_hi)
          colsum[c - cs_lo] = __fadd_rn(colsum[c - cs_lo], v);
      }
    }
  }
}

// rows [T, cols] of a shared-memory tile (row stride lds) to a dense plane
// of the stash (row stride ldd), in 16-byte pieces. The stores are marked
// streaming (evict first): the stash is read once, by K5b, and must not
// push the weights, which every tile reads again, out of L2.
__device__ void copy_rows(bf16* dst, int ldd, const bf16* src, int lds, int cols) {
  const int v = cols / 8;
  for (int e = threadIdx.x; e < T * v; e += THREADS) {
    const int r = e / v, c = (e % v) * 8;
    __stcs(reinterpret_cast<uint4*>(dst + static_cast<long long>(r) * ldd + c),
           *reinterpret_cast<const uint4*>(src + r * lds + c));
  }
}

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

// ReLU masks, one bit per element of a [T, N] layer output (gemm_rows)
__device__ __forceinline__ bool mask_bit(const unsigned short* m, int N, int r,
                                         int c) {
  return (m[r * (N / 16) + c / 16] >> (c & 15)) & 1;
}

// A tile's activations in shared memory: act[0] = enc_x [T, in_pad] (row
// stride lx); act[i] for i ≥ 1, the output h of layer i - 1 [T, W] (lbuf;
// act[D] is the trunk); enc_d (lv); the feature layer's output (lbuf) and
// hv (lh). A layer after a skip takes [enc_x | h] as two operands, and the
// view layer [feature | enc_d], so no tile is wider than W.
struct Bufs {
  bf16* act[MAXD + 1];
  bf16* encd;
  bf16* hvin;
  bf16* hv;
};

// The tile's rows of the stash's A planes (dense): the inputs of W_0..W_{D-1}
// (kin_i wide), the trunk, [feature | enc_d], hv
struct Planes {
  bf16* act[MAXD + 1];
  bf16* hvin;
  bf16* hv;
};

// Encoding and MLP of one tile. xs: the tile's packed input rows [T, 8];
// w: the packed weights of the forward (`pack_fragments`).
// out (optional): [T, 4] raw rgb + sigma without the head biases.
// z0 (optional): [T, W] layer 0's f32 pre-activation (a probe for checks).
// P (optional, K5a): where every layer's input is copied as it is formed.
// mask (optional, K5a): the ReLU masks of the D trunk layers and of hv, one
// bit per element (`mask_bit`), so that the backward reads them from
// shared memory.
__device__ void forward_tile(const Dims& d, const float* xs, const bf16* w,
                             const float* b, const Bufs& B, float* out,
                             float* z0, const Planes* P, unsigned short* mask) {
  const int W = d.W, W2 = d.W / 2, lb = d.lbuf;
  for (int e = threadIdx.x; e < T * d.in_pad; e += THREADS)
    B.act[0][(e / d.in_pad) * d.lx + e % d.in_pad] =
        to_bf16(enc_value(xs + (e / d.in_pad) * 8, e % d.in_pad, d.Lx));
  for (int e = threadIdx.x; e < T * d.vd_pad; e += THREADS)
    B.encd[(e / d.vd_pad) * d.lv + e % d.vd_pad] =
        to_bf16(enc_value(xs + (e / d.vd_pad) * 8 + 4, e % d.vd_pad, d.Ld));
  __syncthreads();
  if (P != nullptr) copy_rows(P->act[0], d.in_pad, B.act[0], d.lx, d.in_pad);
  for (int i = 0; i < d.D; ++i) {
    bf16* dst = B.act[i + 1];
    const bool sk = is_skip(d, i);
    const int off = sk ? d.in_pad : 0;   // h's first column in the stash
    const float* bias = b + static_cast<long long>(i) * W;
    float* zp = i == 0 ? z0 : nullptr;
    unsigned short* mi = mask == nullptr ? nullptr : mask + i * T * (W / 16);
    // the input: enc_x (layer 0), [enc_x | h] (after a skip) or h
    const bool x_in = i == 0 || is_skip(d, i - 1);
    const bool h_in = i > 0;
    const bf16* wi = w + d.w_off[i];
    auto epi = [&](int r, int c, float v) {
      v = __fadd_rn(v, bias[c]);
      if (zp != nullptr) zp[r * W + c] = v;
      const bf16 h = to_bf16(fmaxf(v, 0.f));
      dst[r * lb + c] = h;
      return to_f32(h);
    };
    if (x_in)
      gemm_rows(B.act[0], d.lx, wi, d.in_pad, B.act[i], lb, wi + d.in_pad * W,
                h_in ? W : 0, W, mi, nullptr, 0, 0, epi);
    else
      gemm_rows(B.act[i], lb, wi, W, nullptr, 0, nullptr, 0, W, mi, nullptr, 0, 0,
                epi);
    __syncthreads();
    if (P != nullptr) {
      if (sk) copy_rows(P->act[i + 1], d.kin[i + 1], B.act[0], d.lx, d.in_pad);
      copy_rows(P->act[i + 1] + off, d.kin[i + 1], dst, lb, W);
    }
  }
  const bf16* trunk = B.act[d.D];
  const float* bf = b + static_cast<long long>(d.D) * W;
  const float* bv = bf + W;
  bf16* hvin = B.hvin;
  bf16* hv = B.hv;
  const int lh = d.lh;
  gemm_rows(trunk, lb, w + d.w_off[d.D], W, nullptr, 0, nullptr, 0, W, nullptr,
            nullptr, 0, 0, [&](int r, int c, float v) {
              hvin[r * lb + c] = to_bf16(__fadd_rn(v, bf[c]));
              return 0.f;
            });
  __syncthreads();
  if (P != nullptr) {
    copy_rows(P->hvin, d.kv, hvin, lb, W);
    copy_rows(P->hvin + W, d.kv, B.encd, d.lv, d.vd_pad);
  }
  unsigned short* mh = mask == nullptr ? nullptr : mask + d.D * T * (W / 16);
  const bf16* wv = w + d.w_off[d.D + 1];
  gemm_rows(hvin, lb, wv, W, B.encd, d.lv, wv + W * W2, d.vd_pad, W2, mh,
            nullptr, 0, 0, [&](int r, int c, float v) {
              const bf16 h = to_bf16(fmaxf(__fadd_rn(v, bv[c]), 0.f));
              hv[r * lh + c] = h;
              return to_f32(h);
            });
  __syncthreads();
  if (P != nullptr) copy_rows(P->hv, W2, hv, lh, W2);
  if (out != nullptr) {
    gemm_rows(trunk, lb, w + d.w_off[d.D + 2], W, hv, lh, w + d.w_off[d.D + 3],
              W2, HEAD, nullptr, nullptr, 0, 0, [&](int r, int c, float v) {
                if (c < 4) out[r * 4 + c] = v;
                return 0.f;
              });
  }
  __syncthreads();
}

__device__ void load_rows(const float* xin, long long row0, float* xs) {
  for (int e = threadIdx.x; e < T * 8; e += THREADS) xs[e] = xin[row0 * 8 + e];
}

// the forward's shared tiles (in K5a they share their space with the
// backward's f32 tiles)
__device__ void take_fwd_bufs(const Dims& d, Carve& cv, Bufs* B) {
  // enc_x is dead once the last skip layer has copied it; hv comes after
  B->act[0] = B->hv = cv.take<bf16>(T * (d.lx > d.lh ? d.lx : d.lh));
  bf16* buf[2] = {cv.take<bf16>(static_cast<size_t>(T) * d.lbuf),
                  cv.take<bf16>(static_cast<size_t>(T) * d.lbuf)};
  for (int i = 1; i <= d.D; ++i) B->act[i] = buf[(i - 1) & 1];
  B->hvin = buf[d.D & 1];           // the buffer that does not hold the trunk
}

__global__ void __launch_bounds__(THREADS, 2)
mlp_bwd_pass_kernel(Dims d, const float* __restrict__ xin,
                    const bf16* __restrict__ w, const float* __restrict__ b,
                    const float* __restrict__ g, float* __restrict__ d_xin,
                    bf16* __restrict__ stash, float* __restrict__ db_part,
                    int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* xs = cv.take<float>(T * 8);
  unsigned short* mask = cv.take<unsigned short>(mask_words(d)); // ReLU masks
  Carve fw{cv.p};                  // the forward's tiles, dead after it ...
  Bufs B;
  B.encd = fw.take<bf16>(T * d.lv);
  take_fwd_bufs(d, fw, &B);
  bf16* gB[2] = {cv.take<bf16>(static_cast<size_t>(T) * d.lbuf), // ... then the
                 cv.take<bf16>(static_cast<size_t>(T) * d.lbuf)};// bf16 dZ tiles,
  bf16* gH = cv.take<bf16>(T * LDH);                             // head cotangent,
  float* dx = cv.take<float>(T * d.in_pad);                      // d enc_x,
  float* denc = cv.take<float>(T * d.vd_pad);                    // d enc_d

  const int D = d.D, W = d.W, W2 = d.W / 2, kv = d.kv, lg = d.lbuf;
  const bf16* wb = w + d.w_total;  // the packed transposes, for the backward
  const long long nn = n;
  // plane p of the stash holds [n, width] from element n · column
  auto a_plane = [&](int p) { return stash + nn * d.a_col[p]; };
  auto z_plane = [&](int p) { return stash + nn * d.z_col[p]; };
  auto layer_mask = [&](int i) { return mask + i * T * (W / 16); };
  float* dbp = db_part + blockIdx.x * d.b_total;
  const bool in_grads = d_xin != nullptr;

  for (int tile = blockIdx.x; tile < n / T; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * T;
    Planes P;
    for (int i = 0; i <= D; ++i) P.act[i] = a_plane(i) + row0 * d.kin[i];
    P.hvin = a_plane(D + 1) + row0 * kv;
    P.hv = a_plane(D + 2) + row0 * W2;
    load_rows(xin, row0, xs);
    __syncthreads();
    forward_tile(d, xs, w, b, B, nullptr, nullptr, &P, mask);
    bf16* zh = z_plane(D + 2) + row0 * HEAD;
    for (int e = threadIdx.x; e < T * HEAD; e += THREADS) {
      const int r = e / HEAD, c = e % HEAD;
      const bf16 v = to_bf16(c < 4 ? g[(row0 + r) * 4 + c] : 0.f);
      gH[r * LDH + c] = v;
      zh[e] = v;
    }
    if (in_grads)
      for (int e = threadIdx.x; e < T * d.in_pad; e += THREADS) dx[e] = 0.f;
    __syncthreads();

    // Each product's epilogue applies the ReLU mask of the layer below,
    // writes that layer's bf16 dZ (the next product's operand) and adds
    // its f32 column sums into db; the f32 values that only the input
    // gradient needs go to dx / denc.
    // heads: out = trunk @ Wa + hv @ Wr; dZ of the view layer
    const unsigned short* mhv = mask + D * T * (W / 16);
    gemm_rows(gH, LDH, wb + d.w_off[D + 3], HEAD, nullptr, 0, nullptr, 0, W2,
              nullptr, dbp + (D + 1) * W, 0, W2, [&](int r, int c, float v) {
                v = mask_bit(mhv, W2, r, c) ? v : 0.f;
                gB[0][r * lg + c] = to_bf16(v);
                return v;
              });
    __syncthreads();
    copy_rows(z_plane(D + 1) + row0 * W2, W2, gB[0], lg, W2);
    // view layer on [feature | enc_d]: dZ of the feature layer (no ReLU)
    gemm_rows(gB[0], lg, wb + d.w_off[D + 1], W2, nullptr, 0, nullptr, 0, kv,
              nullptr, dbp + D * W, 0, W, [&](int r, int c, float v) {
                if (c < W) {
                  gB[1][r * lg + c] = to_bf16(v);
                  return v;
                }
                if (in_grads) denc[r * d.vd_pad + c - W] = v;
                return 0.f;
              });
    __syncthreads();
    copy_rows(z_plane(D) + row0 * W, W, gB[1], lg, W);
    // feature layer and the alpha head into the trunk: dZ of layer D - 1
    gemm_rows(gB[1], lg, wb + d.w_off[D], W, gH, LDH, wb + d.w_off[D + 2], HEAD,
              W, nullptr, dbp + (D - 1) * W, 0, W, [&](int r, int c, float v) {
                v = mask_bit(layer_mask(D - 1), W, r, c) ? v : 0.f;
                gB[0][r * lg + c] = to_bf16(v);
                return v;
              });
    __syncthreads();

    // trunk, last layer first: gB[cur] holds dZ_i; the product gives
    // d(input of layer i) = [x | dZ_{i-1} before its mask] after a skip
    int cur = 0;
    for (int i = D - 1; i >= 0; --i) {
      bf16* gz = gB[cur];
      bf16* gn = gB[cur ^ 1];
      copy_rows(z_plane(i) + row0 * W, W, gz, lg, W);
      if (i > 0) {
        const int off = is_skip(d, i - 1) ? d.in_pad : 0;
        const unsigned short* mi = layer_mask(i - 1);
        gemm_rows(gz, lg, wb + d.w_off[i], W, nullptr, 0, nullptr, 0, d.kin[i],
                  nullptr, dbp + (i - 1) * W, off, off + W,
                  [&](int r, int c, float v) {
                    if (c < off) {          // the skip's copy of enc_x
                      if (in_grads) dx[r * d.in_pad + c] = __fadd_rn(dx[r * d.in_pad + c], v);
                      return 0.f;
                    }
                    v = mask_bit(mi, W, r, c - off) ? v : 0.f;
                    gn[r * lg + c - off] = to_bf16(v);
                    return v;
                  });
      } else if (in_grads) {
        gemm_rows(gz, lg, wb + d.w_off[0], W, nullptr, 0, nullptr, 0, d.in_pad,
                  nullptr, nullptr, 0, 0, [&](int r, int c, float v) {
                    dx[r * d.in_pad + c] = __fadd_rn(dx[r * d.in_pad + c], v);
                    return 0.f;
                  });
      }
      __syncthreads();
      cur ^= 1;
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
            s = __fadd_rn(s, __fmul_rn(__fmul_rn(jac, dx[r * d.in_pad + c]), f));
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

// K5b runs on wgmma: two warpgroups per block (64 rows each) share one
// dZ slice, and A and dZ go to the tensor cores straight from shared
// memory. Both operands are MN-major there (the points are the K
// dimension and each point's row is contiguous), stored without swizzle
// as core matrices of 8 points × 8 contiguous columns (128 bytes); a
// descriptor gives the byte offset between core matrices along the K
// dimension (LBO) and along M or N (SBO).
__device__ __forceinline__ unsigned long long smem_desc(const void* p, unsigned lbo,
                                                        unsigned sbo) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<unsigned long long>((a & 0x3FFFF) >> 4) |
         (static_cast<unsigned long long>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<unsigned long long>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_n64(float* d, unsigned long long da,
                                          unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n16(float* d, unsigned long long da,
                                          unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// K5b. Block `split · n_tiles + t` adds, over the points of chunk `split`,
// A_jᵀ · dZ_j into rows m0 .. m0 + rows of dW_j (all its columns), where
// tiles[t] = {j, m0, rows}, rows ≤ 128 and a multiple of 16; it writes
// them once to part[split]. Warpgroup w takes rows m0 + 64w .. + 64; the N
// columns run as wgmma m64n64k16 and m64n16k16 pieces (N = 64a + 16b), all
// accumulators in registers.
__global__ void __launch_bounds__(WG_THREADS)
mlp_wgrad_kernel(Dims d, const bf16* __restrict__ stash,
                 const int* __restrict__ tiles, int n_tiles, int n, int chunk,
                 float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int split = blockIdx.x / n_tiles, t = blockIdx.x % n_tiles;
  const int j = tiles[3 * t], m0 = tiles[3 * t + 1], rows = tiles[3 * t + 2];
  const int M = d.mk[j], N = d.mn[j];
  const long long nn = n;
  const bf16* Ag = stash + nn * d.a_col[d.ma[j]] + m0;
  const bf16* Zg = stash + nn * d.z_col[d.mz[j]];
  constexpr int A_STAGE = KC / 8 * BM * 16;       // bytes: KC/8 × BM/8 cores
  constexpr int Z_STAGE = KC / 8 * 256 * 16;      // at most 32 cores a row
  unsigned char* As = smem;
  unsigned char* Zs = smem + STAGES * A_STAGE;
  const int zk = N * 16;                          // bytes between k-cores of dZ
  const long long p0 = static_cast<long long>(split) * chunk;
  const int steps = static_cast<int>(((nn - p0 < chunk) ? nn - p0 : chunk) / KC);
  const int av = rows / 8, bv = N / 8;

  // This thread's 16-byte pieces of a stage, the same in every stage up to
  // the stage's first point: (offset in the global rows, byte offset in
  // the slice's core-matrix layout), -1 where it has none.
  constexpr int A_PER = (KC * BM / 8 + WG_THREADS - 1) / WG_THREADS;
  constexpr int Z_PER = (KC * 32 + WG_THREADS - 1) / WG_THREADS;
  int a_g[A_PER], a_s[A_PER], z_g[Z_PER], z_s[Z_PER];
#pragma unroll
  for (int q = 0; q < A_PER; ++q) {
    const int e = threadIdx.x + q * WG_THREADS, r = e / av, v = e % av;
    a_g[q] = r * M + v * 8;
    a_s[q] = e < KC * av ? (r / 8) * (BM * 16) + v * 128 + (r % 8) * 16 : -1;
  }
#pragma unroll
  for (int q = 0; q < Z_PER; ++q) {
    const int e = threadIdx.x + q * WG_THREADS, r = e / bv, v = e % bv;
    z_g[q] = r * N + v * 8;
    z_s[q] = e < KC * bv ? (r / 8) * zk + v * 128 + (r % 8) * 16 : -1;
  }
  auto issue = [&](int s) {
    if (s < steps) {
      const long long p = p0 + static_cast<long long>(s) * KC;
      const bf16* ag = Ag + p * M;
      const bf16* zg = Zg + p * N;
      unsigned char* a = As + (s % STAGES) * A_STAGE;
      unsigned char* z = Zs + (s % STAGES) * Z_STAGE;
#pragma unroll
      for (int q = 0; q < A_PER; ++q)
        if (a_s[q] >= 0) cp_async16(a + a_s[q], ag + a_g[q]);
#pragma unroll
      for (int q = 0; q < Z_PER; ++q)
        if (z_s[q] >= 0) cp_async16(z + z_s[q], zg + z_g[q]);
    }
    cp_async_commit();    // an empty group past the end keeps the count
  };

  const int n64 = N / 64, n16 = N % 64 / 16;
  const int wg = threadIdx.x / 128;
  const bool active = 64 * wg < rows;   // uniform in a warpgroup
  float acc64[4][32], acc16[3][8];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc64[c][e] = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc16[c][e] = 0.f;

  // the accumulators are the wgmmas' until a wait: nothing may touch them
  // across one
  auto hold = [&]() {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(acc64[c][e])::"memory");
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e) asm volatile("" : "+f"(acc16[c][e])::"memory");
  };
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    // this thread's copies of stage s, seen by the async proxy wgmma uses
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // stage s - 1's products are done before any thread refills its slot
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    hold();
    __syncthreads();             // stage s landed; stage s - 1 is free
    issue(s + STAGES - 1);
    const unsigned char* a = As + (s % STAGES) * A_STAGE;
    const unsigned char* z = Zs + (s % STAGES) * Z_STAGE;
    if (!active) continue;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < KC / 16; ++k) {
      const unsigned long long da =
          smem_desc(a + k * 2 * A_LBO + wg * 8 * A_SBO, A_LBO, A_SBO);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < n64)
          wgmma_n64(acc64[c], da, smem_desc(z + k * 2 * zk + c * 64 * 16, zk, 128));
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (c < n16)
          wgmma_n16(acc16[c], da,
                    smem_desc(z + k * 2 * zk + (n64 * 64 + c * 16) * 16, zk, 128));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  hold();
  cp_async_wait<0>();

  // accumulator layout of m64nNk16: warp w holds rows 16w + g and
  // 16w + g + 8 (g = lane / 4), columns 8i + 2(lane % 4) + {0, 1}
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4, c0 = 2 * (lane % 4);
  float* out = part + split * d.w_total + d.w_off[j] +
               static_cast<long long>(m0) * N;
  auto put = [&](const float* acc, int n0, int regs) {
#pragma unroll
    for (int e = 0; e < 32; e += 4) {
      if (e >= regs) break;
      const int col = n0 + 8 * (e / 4) + c0;
      if (r0 < rows)
        *reinterpret_cast<float2*>(out + r0 * N + col) = make_float2(acc[e], acc[e + 1]);
      if (r0 + 8 < rows)
        *reinterpret_cast<float2*>(out + (r0 + 8) * N + col) =
            make_float2(acc[e + 2], acc[e + 3]);
    }
  };
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < n64) put(acc64[c], c * 64, 32);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    if (c < n16) put(acc16[c], n64 * 64 + c * 16, 8);
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

// ------------------------------------------------------------------- K4
//
// K4, `mlp_fwd_ws_kernel<W>`: the forward, persistent and warp-specialised
// on wgmma. What held the per-tile kernel back was that every block of 64
// points read all the weights (1.2 MB at 8×256) from L2 through register
// loads, on mma.sync, one tile per block. Here:
//   * one block per SM (grid min(SMs, tiles)) walks tiles b, b + G, ...
//     of K4_T = 128 points; the schedule depends only on n and the card,
//     so the result is bit-equal from launch to launch;
//   * three warpgroups: consumers 0 and 1 own rows 0:64 and 64:128 of the
//     tile (wgmma m64nNk16, f32 accumulators in registers, setmaxnreg
//     232), and one thread of the third (setmaxnreg 40) streams the
//     weights;
//   * the weights come as one byte image of the ring's stages (packed by
//     the wrapper, `k4_weight_stream` in ops/cuda/mlp_kernel.py): each
//     stage is one K-slice of at most 64 rows of one matrix's operand,
//     stored as Wᵀ [N, 64] K-major in the 128-byte swizzle that a wgmma
//     descriptor reads, zero-padded to 64 rows, so a stage is one
//     contiguous cp.async.bulk whose bytes are counted on a "full"
//     mbarrier. The slice order is the same for every tile (W_0 ..
//     W_{D-1}, alpha, feature, views, rgb), so the producer runs ahead
//     across layers and tiles, held back only by the "empty" mbarriers
//     the consumers' warps arrive on once a stage's products retired;
//   * each consumer keeps its 64 rows of enc_x, enc_d and one W-wide
//     activation tile in shared memory, all in the same swizzled layout
//     (64 columns a block). A layer's products all retire
//     (wgmma.wait_group 0) before its epilogue (bias, ReLU, bf16 rounding)
//     rewrites the activation tile in place; `fence.proxy.async` then
//     makes the generic stores visible to the next layer's wgmma. While a
//     slice's products run, the next slice is waited for and issued: one
//     product group stays in flight across slices, layers and matrices.
//     That holds only while every wgmma, fence and wait sits on a path
//     that ptxas sees taken by the whole warpgroup: under a branch on the
//     thread's consumer (`active` below) it waits for each product before
//     the next (C7520), ≈ 15 % of the kernel at 8×256; so the products,
//     fences and waits run on every path, and only the epilogues, the
//     encoding and the stores stay on the branch. The two consumers then
//     overlap each other's drains and epilogues without an enforced
//     order: the ping-pong order of FlashAttention-3 (named barriers,
//     turns of stages - 1 slices; modelled by mlp_kernel.k4_order's
//     `turns`) was slower at every width (PERF.md, Findings);
//   * each consumer writes its rows' Fourier encoding at the start of a
//     tile, one sincosf for each sin/cos channel pair (`encode_rows`);
//     on an H100 it costs ≈ 7 % of the kernel's time, less than the
//     encoder warps or the encoding hidden under the products, measured
//     against it (PERF.md, Findings);
//   * a layer after a skip takes [enc_x | h] and the view layer [feature |
//     enc_d] as two operands; the alpha head reads the trunk, so its
//     slices come before the feature layer's and its products stay in
//     flight until the feature layer's epilogue; the rgb head then adds
//     hv · W_rgb into the same 16-column accumulator.
// A consumer with no rows in a tile (the last tile may hold 64) waits on
// and releases every stage all the same, or the producer would stall, and
// multiplies whatever its tiles hold, writing nothing to device memory.

constexpr int K4_T = 128;                  // points per tile
constexpr int K4_THREADS = 384;            // consumers 0, 1; producer 2
constexpr int K4_BLOCK = 64 * 128;         // bytes of [64 rows, 64 bf16]
constexpr int K4_MAX_STAGES = 8;
constexpr size_t K4_SMEM_LIMIT = 232448;   // a block's shared memory
constexpr unsigned K4_SPIN_LIMIT = 1u << 28;

// The stream and the shared-memory plan: matrices in stream order, each
// with its output width N and its K-slices (one per 64 columns of each
// operand); a stage holds the largest slice, N = W. Shared memory, from a
// 1024-aligned base: the ring's stages; `nb` encoding buffers, each the
// enc_x and enc_d tiles of both consumers; each consumer's activation
// tile; the barriers.
struct K4Plan {
  int n_mat;
  int mat_n[MAXD + 4];
  int mat_slices[MAXD + 4];
  long long stream_bytes;
  int bx, bd, ba;                // 64-column blocks of enc_x, enc_d, act
  int stages, slot;              // ring stages, bytes a stage
  size_t smem;
};

int blocks64(int k) { return (k + 63) / 64; }

bool make_k4(const Dims& d, K4Plan* out) {
  K4Plan p;
  const int D = d.D, W = d.W;
  p.n_mat = D + 4;
  for (int i = 0; i < D; ++i) {
    p.mat_n[i] = W;
    p.mat_slices[i] = (i == 0 || is_skip(d, i - 1) ? blocks64(d.in_pad) : 0) +
                      (i > 0 ? blocks64(W) : 0);
  }
  p.mat_n[D] = HEAD;      p.mat_slices[D] = blocks64(W);                 // alpha
  p.mat_n[D + 1] = W;     p.mat_slices[D + 1] = blocks64(W);             // feature
  p.mat_n[D + 2] = W / 2; p.mat_slices[D + 2] = blocks64(W) + blocks64(d.vd_pad);
  p.mat_n[D + 3] = HEAD;  p.mat_slices[D + 3] = blocks64(W / 2);         // rgb
  p.stream_bytes = 0;
  for (int m = 0; m < p.n_mat; ++m)
    p.stream_bytes += static_cast<long long>(p.mat_slices[m]) * p.mat_n[m] * 128;
  p.bx = blocks64(d.in_pad);
  p.bd = blocks64(d.vd_pad);
  p.ba = blocks64(W);
  p.slot = 128 * W;
  // 1024 bytes to align the swizzle atoms, both consumers' tiles, barriers
  const size_t fixed =
      1024 + 2 * static_cast<size_t>(K4_BLOCK) * (p.bx + p.bd + p.ba) +
      16 * K4_MAX_STAGES;
  if (fixed + 2 * static_cast<size_t>(p.slot) > K4_SMEM_LIMIT) return false;
  const size_t fit = (K4_SMEM_LIMIT - fixed) / p.slot;
  p.stages = fit < K4_MAX_STAGES ? static_cast<int>(fit) : K4_MAX_STAGES;
  p.smem = fixed + static_cast<size_t>(p.stages) * p.slot;
  *out = p;
  return true;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Wait until the barrier's phase with the given parity has completed. A
// stage that never arrives (a fault in the stream's bookkeeping) traps
// after about 2^28 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned ok = 0, spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++spins == K4_SPIN_LIMIT) __trap();
  } while (!ok);
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
      "%2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of consumer warpgroup `wg` (named barriers 1, 2)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A K-major operand of 64-column blocks, each [rows, 64] bf16 with rows of
// 128 bytes, 16-byte chunk j of row r stored at chunk j ^ (r % 8) (the
// 128-byte swizzle; atoms of 8 rows, 1024 bytes, 1024-aligned). Its
// descriptor: SBO = 1024 bytes between 8-row atoms; LBO unused (a k16
// step stays inside one 128-byte row); layout type 1 = 128-byte swizzle.
// A k16 step advances the start address by 32 bytes.
__device__ __forceinline__ unsigned long long sw128_desc(unsigned addr) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// byte offset of bf16 element (r, c) in such a [64, K] tile
__device__ __forceinline__ unsigned sw128(int r, int c) {
  return (c >> 6) * K4_BLOCK + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

// wgmma m64nNk16, bf16 operands both K-major from shared memory, f32
// accumulators; scale 0 starts from zero
template <int N>
__device__ __forceinline__ void wgmma_k(float* d, unsigned long long da,
                                        unsigned long long db, int scale);

template <>
__device__ __forceinline__ void wgmma_k<16>(float* d, unsigned long long da,
                                            unsigned long long db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_k<32>(float* d, unsigned long long da,
                                            unsigned long long db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_k<64>(float* d, unsigned long long da,
                                            unsigned long long db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_k<128>(float* d, unsigned long long da,
                                            unsigned long long db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_k<256>(float* d, unsigned long long da,
                                            unsigned long long db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale));
}

constexpr int acc_piece(int n) {
  return n >= 256 ? 256 : n >= 128 ? 128 : n >= 64 ? 64 : n >= 32 ? 32 : 16;
}

// The accumulators of a [64, N] product for one warpgroup: N (a multiple
// of 16, ≤ 256) as pieces of 256, 128, 64, 32, 16 columns, one wgmma each.
template <int N>
struct Acc {
  static constexpr int P = acc_piece(N);
  float d[P / 2];
  Acc<N - P> rest;
};
template <>
struct Acc<0> {};

// acc (+)= A[64, 16] · B[16, N]; B's rows n0.. of the stage start n0 · 128
// bytes further
template <int N>
__device__ __forceinline__ void mma(Acc<N>& a, unsigned long long da,
                                    unsigned long long db, int scale) {
  wgmma_k<Acc<N>::P>(a.d, da, db, scale);
  if constexpr (N > Acc<N>::P) mma(a.rest, da, db + Acc<N>::P * 8, scale);
}

// the accumulators belong to the wgmmas until a wait: nothing may read
// them across one, or write them between the products
template <int N>
__device__ __forceinline__ void fence_acc(Acc<N>& a) {
#pragma unroll
  for (int e = 0; e < Acc<N>::P / 2; ++e) asm volatile("" : "+f"(a.d[e])::"memory");
  if constexpr (N > Acc<N>::P) fence_acc(a.rest);
}

template <int N>
__device__ __forceinline__ void zero_acc(Acc<N>& a) {
#pragma unroll
  for (int e = 0; e < Acc<N>::P / 2; ++e) a.d[e] = 0.f;
  if constexpr (N > Acc<N>::P) zero_acc(a.rest);
}

// f(c, v) for each of this thread's 8-column groups: v0, v1 at row
// rq = 16·warp + lane / 4, columns c, c + 1 (c = 8i + 2·(lane % 4));
// v2, v3 at row rq + 8
template <int N, int N0 = 0, typename F>
__device__ __forceinline__ void for_cols(Acc<N>& a, int cq, F f) {
#pragma unroll
  for (int e = 0; e < Acc<N>::P / 2; e += 4)
    f(N0 + 2 * e + cq, a.d[e], a.d[e + 1], a.d[e + 2], a.d[e + 3]);
  if constexpr (N > Acc<N>::P) for_cols<N - Acc<N>::P, N0 + Acc<N>::P>(a.rest, cq, f);
}

// A consumer's view of the ring: the stage and phase it reads next, and
// the stage whose products may still be in flight (-1: none).
struct Ring {
  unsigned slots, full, empty;
  int stages, slot, stage, pend;
  unsigned phase;

  // one arrival per warp (the empty barriers count 8: 4 warps × 2
  // consumers), after the warp's wgmma.wait_group covered the stage
  __device__ __forceinline__ void release(int s) {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * s);
  }
};

// acc (+)= [A_0 | A_1] · B: A_o is the [64, k_o] tile at shared address
// a_o (k_1 = 0: no second operand); B's K-slices are the ring's next
// stages, one per 64 columns of each operand in order. `accumulate` false
// starts from zero. Each slice's products are one group; once it is
// issued, the previous group is waited for and its stage released, so the
// last slice's products may be in flight on return (rg.pend). A consumer
// with no rows issues them all the same (a wgmma on a branch of the
// consumer is serialised: see the K4 notes).
template <int N>
__device__ __forceinline__ void gemm(Acc<N>& acc, Ring& rg, unsigned a0, int k0,
                                     unsigned a1, int k1, bool accumulate) {
  int scale = accumulate ? 1 : 0;
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const unsigned ao = o ? a1 : a0;
    const int ko = o ? k1 : k0;
    for (int c0 = 0; c0 < ko; c0 += 64) {
      mbar_wait(rg.full + 8 * rg.stage, rg.phase);
      const unsigned long long da = sw128_desc(ao + (c0 >> 6) * K4_BLOCK);
      const unsigned long long db = sw128_desc(rg.slots + rg.stage * rg.slot);
      const int ks = (ko - c0 < 64 ? ko - c0 : 64) / 16;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s < ks) {
          mma(acc, da + 2 * s, db + 2 * s, scale);
          scale = 1;
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (rg.pend >= 0) rg.release(rg.pend);
      rg.pend = rg.stage;
      if (++rg.stage == rg.stages) {
        rg.stage = 0;
        rg.phase ^= 1;
      }
    }
  }
}

// every product retired; the last stage released
__device__ __forceinline__ void drain(Ring& rg) {
  wgmma_wait<0>();
  if (rg.pend >= 0) rg.release(rg.pend);
  rg.pend = -1;
}

__device__ __forceinline__ void st_bf2(unsigned char* tile, int r, int c, float v0,
                                       float v1) {
  *reinterpret_cast<__nv_bfloat162*>(tile + sw128(r, c)) =
      __halves2bfloat162(to_bf16(v0), to_bf16(v1));
}

// The encoding of rows row0 .. row0 + 63 (xyz at lane 0 of each input
// row, or the view direction at lane 4) into a [64, pad] swizzled tile,
// as enc_value computes it: channel 3 + 6k + d is sin(x_d·2^k) and the
// channel three on its cosine, the phase exact in f32. Threads 2r and
// 2r + 1 take row r, each every other (k, d): one sincosf gives both
// channels from one range reduction, with the bits of sinf and cosf
// (tests/test_torch_gpu.py's K4 tests bound layer 0's product of them), and
// the unrolled loop keeps several independent chains in flight. The
// padding channels are written as zeros: the products read them.
__device__ __forceinline__ void encode_rows(unsigned char* tile, const float* xin,
                                            long long row0, int lane0, int pad,
                                            int L, int t) {
  const int r = t >> 1, h = t & 1;
  const float* x3 = xin + (row0 + r) * 8 + lane0;
  const float x = __ldg(x3), y = __ldg(x3 + 1), z = __ldg(x3 + 2);
  if (h == 0) {
    *reinterpret_cast<bf16*>(tile + sw128(r, 0)) = to_bf16(x);
    *reinterpret_cast<bf16*>(tile + sw128(r, 1)) = to_bf16(y);
    *reinterpret_cast<bf16*>(tile + sw128(r, 2)) = to_bf16(z);
  }
  for (int c = 3 + 6 * L + h; c < pad; c += 2)
    *reinterpret_cast<bf16*>(tile + sw128(r, c)) = to_bf16(0.f);
#pragma unroll 8
  for (int u = h; u < 3 * L; u += 2) {
    const int k = u / 3, dim = u % 3;
    const float ph = (dim == 0 ? x : dim == 1 ? y : z) * static_cast<float>(1u << k);
    float sn, cs;
    sincosf(ph, &sn, &cs);
    *reinterpret_cast<bf16*>(tile + sw128(r, 3 + 6 * k + dim)) = to_bf16(sn);
    *reinterpret_cast<bf16*>(tile + sw128(r, 6 + 6 * k + dim)) = to_bf16(cs);
  }
}

template <int W>
__global__ void __launch_bounds__(K4_THREADS, 1)
mlp_fwd_ws_kernel(const __grid_constant__ Dims d, const __grid_constant__ K4Plan p,
                  const float* __restrict__ xin,
                  const unsigned char* __restrict__ stream,
                  const float* __restrict__ b, float* __restrict__ out,
                  float* __restrict__ z0, int n) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the shared address: atoms 1024-aligned
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const size_t enc = static_cast<size_t>(K4_BLOCK) * (p.bx + p.bd);  // one consumer's
  unsigned char* encs = base + static_cast<size_t>(p.stages) * p.slot;
  unsigned char* acts = encs + 2 * enc;
  const unsigned slots = smem_u32(base);
  const unsigned full = smem_u32(acts + 2 * static_cast<size_t>(K4_BLOCK) * p.ba);
  const unsigned empty = full + 8 * p.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_tiles = (n + K4_T - 1) / K4_T;

  if (threadIdx.x >= 256) {
    // producer: one thread issues every stage's copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int stage = 0;
      unsigned phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const unsigned char* src = stream;
        for (int m = 0; m < p.n_mat; ++m) {
          const unsigned bytes = static_cast<unsigned>(p.mat_n[m]) * 128;
          for (int s = 0; s < p.mat_slices[m]; ++s) {
            mbar_wait(empty + 8 * stage, phase ^ 1);
            mbar_expect_tx(full + 8 * stage, bytes);
            bulk_load(slots + stage * p.slot, src, bytes, full + 8 * stage);
            src += bytes;
            if (++stage == p.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
    const int lane = t & 31;
    const int rq = 16 * (t >> 5) + (lane >> 2), cq = 2 * (lane & 3);
    unsigned char* ht = acts + wg * static_cast<size_t>(K4_BLOCK) * p.ba;
    const unsigned ah = smem_u32(ht);
    unsigned char* xt = encs + wg * enc;                 // enc_x
    unsigned char* dt = xt + p.bx * K4_BLOCK;            // enc_d
    const unsigned ax = smem_u32(xt), ad = smem_u32(dt);
    Ring rg{slots, full, empty, p.stages, p.slot, 0, -1, 0u};
    const int D = d.D;
    Acc<W> acc;
    Acc<W / 2> accv;
    Acc<HEAD> acch;
    zero_acc(acc);
    zero_acc(accv);
    zero_acc(acch);

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long long row0 = static_cast<long long>(tile) * K4_T + 64 * wg;
      const bool active = row0 < n;     // uniform in the warpgroup
      // the last tile's reads of the encoding retired with its view layer
      if (active) {
        encode_rows(xt, xin, row0, 0, d.in_pad, d.Lx, t);
        encode_rows(dt, xin, row0, 4, d.vd_pad, d.Ld, t);
        fence_proxy_async();
      }
      wg_sync(wg);
      for (int i = 0; i < D; ++i) {
        // [enc_x] (layer 0), [enc_x | h] (after a skip) or [h]
        if (i == 0)
          gemm(acc, rg, ax, d.in_pad, 0u, 0, false);
        else if (is_skip(d, i - 1))
          gemm(acc, rg, ax, d.in_pad, ah, W, false);
        else
          gemm(acc, rg, ah, W, 0u, 0, false);
        drain(rg);
        fence_acc(acc);
        if (active) {
          const float* bias = b + static_cast<long long>(i) * W;
          float* zp = (i == 0 && z0 != nullptr) ? z0 + row0 * W : nullptr;
          for_cols(acc, cq, [&](int c, float v0, float v1, float v2, float v3) {
            const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + c));
            const float z00 = __fadd_rn(v0, bb.x), z01 = __fadd_rn(v1, bb.y);
            const float z10 = __fadd_rn(v2, bb.x), z11 = __fadd_rn(v3, bb.y);
            if (zp != nullptr) {
              *reinterpret_cast<float2*>(zp + rq * W + c) = make_float2(z00, z01);
              *reinterpret_cast<float2*>(zp + (rq + 8) * W + c) = make_float2(z10, z11);
            }
            st_bf2(ht, rq, c, fmaxf(z00, 0.f), fmaxf(z01, 0.f));
            st_bf2(ht, rq + 8, c, fmaxf(z10, 0.f), fmaxf(z11, 0.f));
          });
          fence_proxy_async();
        }
        wg_sync(wg);
      }
      // the alpha head on the trunk stays in flight through the feature
      // layer's products; both retire before the trunk is overwritten
      gemm(acch, rg, ah, W, 0u, 0, false);
      gemm(acc, rg, ah, W, 0u, 0, false);
      drain(rg);
      fence_acc(acc);
      fence_acc(acch);
      if (active) {
        const float* bias = b + static_cast<long long>(D) * W;
        for_cols(acc, cq, [&](int c, float v0, float v1, float v2, float v3) {
          const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + c));
          st_bf2(ht, rq, c, __fadd_rn(v0, bb.x), __fadd_rn(v1, bb.y));
          st_bf2(ht, rq + 8, c, __fadd_rn(v2, bb.x), __fadd_rn(v3, bb.y));
        });
        fence_proxy_async();
      }
      // the next read of acc starts from zero (scale 0): dead until then
      zero_acc(acc);
      wg_sync(wg);
      // the view layer on [feature | enc_d]; hv replaces the first W/2
      // columns of the activation tile
      gemm(accv, rg, ah, W, ad, d.vd_pad, false);
      drain(rg);
      fence_acc(accv);
      if (active) {
        const float* bias = b + static_cast<long long>(D + 1) * W;
        for_cols(accv, cq, [&](int c, float v0, float v1, float v2, float v3) {
          const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + c));
          st_bf2(ht, rq, c, fmaxf(__fadd_rn(v0, bb.x), 0.f),
                 fmaxf(__fadd_rn(v1, bb.y), 0.f));
          st_bf2(ht, rq + 8, c, fmaxf(__fadd_rn(v2, bb.x), 0.f),
                 fmaxf(__fadd_rn(v3, bb.y), 0.f));
        });
        fence_proxy_async();
      }
      zero_acc(accv);
      wg_sync(wg);
      // the rgb head adds hv · W_rgb to alpha's columns
      gemm(acch, rg, ah, W / 2, 0u, 0, true);
      drain(rg);
      fence_acc(acch);
      // columns 0:4 of the head tile: lanes with cq < 4 hold them
      if (active && cq < 4) {
        *reinterpret_cast<float2*>(out + (row0 + rq) * 4 + cq) =
            make_float2(acch.d[0], acch.d[1]);
        *reinterpret_cast<float2*>(out + (row0 + rq + 8) * 4 + cq) =
            make_float2(acch.d[2], acch.d[3]);
      }
      zero_acc(acch);
    }
  }
}

template <int W>
int launch_k4(const Dims& d, const K4Plan& p, const void* xin, const void* w,
              const void* b, void* out, void* z0, int n, int grid, cudaStream_t s) {
  static std::atomic<size_t> allowed[kMaxDevices];
  cudaError_t err = allow_smem(mlp_fwd_ws_kernel<W>, allowed, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_fwd_ws_kernel<W><<<grid, K4_THREADS, p.smem, s>>>(
      d, p, static_cast<const float*>(xin), static_cast<const unsigned char*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), static_cast<float*>(z0),
      n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sizes[0] = flat weight elements, [1] = flat bias elements, [2] = bf16
// stash elements per point (K5), [3] = K4, [4] = K5a shared bytes, [5] =
// bytes of K4's weight stream, [6] = K4's ring stages.
// Returns 0, or cudaErrorInvalidValue for dims the kernels refuse.
extern "C" int nerf_mlp_sizes(const int* dims, long long* sizes) {
  Dims d;
  K4Plan p;
  if (!make_dims(dims, &d) || !make_k4(d, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  sizes[0] = d.w_total;
  sizes[1] = d.b_total;
  sizes[2] = d.stash_cols;
  sizes[3] = static_cast<long long>(p.smem);
  sizes[4] = static_cast<long long>(bwd_smem(d));
  sizes[5] = p.stream_bytes;
  sizes[6] = p.stages;
  return 0;
}

// K4: out [n, 4] from xin [n, 8]; n a multiple of 64. w: the weight
// stream (`k4_weight_stream`: sizes[5] bytes, 16-byte aligned). z0 may be
// null. Grid: one block per SM, fewer for a short input.
extern "C" int nerf_mlp_fwd_launch(const int* dims, const void* xin,
                                   const void* w, const void* b, void* out,
                                   void* z0, int n, void* stream) {
  Dims d;
  K4Plan p;
  if (!make_dims(dims, &d) || !make_k4(d, &p) || n <= 0 || n % T)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + K4_T - 1) / K4_T;
  const int grid = tiles < sms ? tiles : sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d.W) {
    case 32: return launch_k4<32>(d, p, xin, w, b, out, z0, n, grid, s);
    case 64: return launch_k4<64>(d, p, xin, w, b, out, z0, n, grid, s);
    case 96: return launch_k4<96>(d, p, xin, w, b, out, z0, n, grid, s);
    case 128: return launch_k4<128>(d, p, xin, w, b, out, z0, n, grid, s);
    case 160: return launch_k4<160>(d, p, xin, w, b, out, z0, n, grid, s);
    case 192: return launch_k4<192>(d, p, xin, w, b, out, z0, n, grid, s);
    case 224: return launch_k4<224>(d, p, xin, w, b, out, z0, n, grid, s);
    case 256: return launch_k4<256>(d, p, xin, w, b, out, z0, n, grid, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5a: the per-point stash [n · sizes[2]] bf16, db [b_total] (and d_xin
// [n, 8] unless null) from g [n, 4]. w: both halves of the packed weights.
// db_part [n_blocks, b_total] f32, zero on entry.
extern "C" int nerf_mlp_bwd_pass_launch(const int* dims, const void* xin,
                                        const void* w, const void* b,
                                        const void* g, void* d_xin, void* stash,
                                        void* db_part, void* db, int n,
                                        int n_blocks, void* stream) {
  Dims d;
  if (!make_dims(dims, &d) || n <= 0 || n % T || n_blocks <= 0 ||
      n_blocks > n / T)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem(d);
  static std::atomic<size_t> allowed[kMaxDevices];
  cudaError_t err = allow_smem(mlp_bwd_pass_kernel, allowed, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_bwd_pass_kernel<<<n_blocks, THREADS, smem, s>>>(
      d, static_cast<const float*>(xin), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<const float*>(g),
      static_cast<float*>(d_xin), static_cast<bf16*>(stash),
      static_cast<float*>(db_part), n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce(static_cast<const float*>(db_part), n_blocks,
                       d.b_total, static_cast<float*>(db), s);
}

// K5b: dw [w_total] from the stash K5a wrote. tiles: n_tiles · {j, m0,
// rows} int32 on the device, covering every row of every dW_j once;
// chunk: points per split, a multiple of 64; part: [ceil(n / chunk),
// w_total] f32 (every entry written).
extern "C" int nerf_mlp_wgrad_launch(const int* dims, const void* stash,
                                     const void* tiles, int n_tiles, int n,
                                     int chunk, void* part, void* dw,
                                     void* stream) {
  Dims d;
  if (!make_dims(dims, &d) || n <= 0 || n % T || n_tiles <= 0 ||
      chunk <= 0 || chunk % T)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = (n + chunk - 1) / chunk;
  const size_t smem = wgrad_smem();
  static std::atomic<size_t> allowed[kMaxDevices];
  cudaError_t err = allow_smem(mlp_wgrad_kernel, allowed, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_wgrad_kernel<<<splits * n_tiles, WG_THREADS, smem, s>>>(
      d, static_cast<const bf16*>(stash), static_cast<const int*>(tiles),
      n_tiles, n, chunk, static_cast<float*>(part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce(static_cast<const float*>(part), splits, d.w_total,
                       static_cast<float*>(dw), s);
}
