// elastic_dense — the tile-skipping elastic dense layer, fp32, for sm_90a.
//
// Replaces the Pallas TPU kernel `_edense_kernel` / `_edense_call` in
// src/repro/kernels/elastic_matmul.py, forward and closed VJP (the VJP
// launches this kernel again on transposed operands). Computes, for every
// group g of a (G, M, K) input
//
//     y[g] = R_m · C_n · act((x[g] · P_k) @ w[g] + b)
//
// with per-group runtime prefixes k_active[g] (contraction), n_active[g]
// (output columns) and m_active[g] (rows), read from (G,) int32 device
// tensors, so a change of submodel changes tensor values and never the
// launch. w is (K, N), shared by all groups (serving), or (G, K, N), one
// per group (training: every client its own weights, the reference's
// `vmap`). bias is (N,), shared by all groups, or one (N,) row per group
// at the group stride b_gstride (training: the client-stacked (G, N) bias
// of a conv lowered onto this kernel, kernels/elastic_conv.py); a shared
// bias is b_gstride 0, the same loads and bits. act is 0 none, 1 silu,
// 2 gelu (tanh approximation), 3 relu. Shapes that are not tile multiples are masked
// inside the kernel; nothing is padded on the host.
//
// Layout flags: x may be stored transposed per group ((G, K, M), the xᵀ
// of the VJP's dw = xᵀ @ dpre) and w transposed ((N, K) or (G, N, K), the
// wᵀ of dx = dpre @ wᵀ), and a per-group w may sit at any group stride (one
// layer of a client-stacked (G, L, K, N) parameter); the kernel reads them
// in place, so neither pass copies an operand.
//
// The (G, M) axes are flattened to R = G·M rows, each carrying its group's
// prefixes, so the serving path's two uses share one entry point: decode
// (G = slots, M = 1: every slot a different submodel) and prefill
// (G = 1, M = prompt length). With a per-group w (or a transposed x) the
// row tiles never straddle a group: the grid's row axis is G · ⌈M/BM⌉.
//
// What bounds it on the H100: the training products (M = 512 token rows
// per client, K and N 4096 or 12800, both passes) do 2·G·M·K·N operations,
// far above the card's ridge — bound by operations. fp32 outside the tensor
// cores peaks at 67 TFLOP/s, which a SIMT kernel can at best equal; TF32
// alone would break the port's fp32 parity. So the products run on the
// tensor cores in 3×TF32 (csrc/mma_tf32.cuh): three TF32 products per fp32
// product, a ceiling of 495 / 3 ≈ 165 TFLOP/s at about fp32 accuracy. The
// serving products (R ≤ 64 rows: decode R = slots, prefill R = prompt
// length) have R/2 operations per weight byte, below the ridge: bound by
// the weight bytes over 3.35 TB/s (210 MB per call at granite-3-8b).
//
// Three variants, chosen by the launch plan (kernels/elastic_matmul.py::
// _plan) from the shapes, the layout flags, the operands' 16-byte
// alignment and the SM count — never from the prefixes:
//  * tile (`edense_mma_kernel`, BM = 128): any product with more than 64
//    rows per row tile — the six training products and the eval forward.
//    A 128 × 128 output tile per 256-thread block, 8 warps of 64 × 32
//    each, mma.sync m16n8k8 in 3×TF32, fed by a 3-stage cp.async ring of
//    16-byte copies (32-deep stages, ~37 KB each, dynamic shared memory),
//    registers bounded for two blocks per SM. Each operand is copied in its
//    stored layout (x or xᵀ, w or wᵀ) and never transposed: `Stage` pads
//    it so that the fragment loads of a warp hit distinct banks in either
//    layout, and a K-contiguous operand's fragment pair loads as one 64-bit
//    word. (`wgmma` would need both operands K-major in shared memory,
//    which two of the three layouts are not.)
//  * skinny (the same kernel with BM = 16, 32 or 64 and 4 warps of
//    BM × 32): products with at most 64 rows — the serving path's decode
//    and prefill, bound by the weight stream. 16-byte copies along N in
//    512-byte row segments (BN = 128 streamed faster on the card than
//    256-byte ones), a 3-stage ring, three blocks per SM up to 32 rows
//    (~100 KB of weight in flight per SM), and a split of the
//    contraction that fills every resident slot of the card in one wave.
//    x travels in the same ring (its stage is 2–9 KB, read from L2 by
//    every column block).
//  * simt (`edense_tiled_kernel`): the first design, a 64 × 64 SIMT tile
//    with 16-deep K steps and fmaf, kept only for operands whose rows are
//    not 16-byte aligned (K or N not a multiple of 4 where that is the
//    stored row length), which cp.async cannot copy.
// Every variant: the K loop of a tile stops at the largest k prefix of its
// live rows, rows past their own prefix read zeros (a 16-byte copy reads
// only the live bytes and zero-fills the rest), and a tile with no live
// output issues no loads and no math and still writes its zeros. Bias,
// activation and the m / n masks are applied in the epilogue.
//
// Split-K: where the output tiles alone are too few to fill the card,
// the contraction is split into chunks (a multiple of the 32-deep stage).
// Each chunk writes its raw partial sums to a (splits, R, N) scratch buffer
// and a second kernel adds them in a fixed order and applies bias,
// activation and masks — deterministic, no atomics.
#include <cuda_runtime.h>
#include <math.h>

#include "mma_tf32.cuh"
#include "tile_counters.cuh"

namespace {

constexpr float kSqrt2OverPi = 0.7978845608028654f;

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case 1:  // silu: x * sigmoid(x)
      return v / (1.0f + expf(-v));
    case 2: {  // gelu, tanh approximation
      float u = kSqrt2OverPi * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.0f + tanhf(u));
    }
    case 3:
      return fmaxf(v, 0.0f);
    default:
      return v;
  }
}

// Group g's prefix, or the full extent when the prefix is absent (null).
__device__ __forceinline__ int prefix(const int* p, int g, int full) {
  return p != nullptr ? p[g] : full;
}

// Layout flags of `edense_forward` (see the header).
constexpr int kXTrans = 1;     // x stored (G, K, M)
constexpr int kWTrans = 2;     // w stored (N, K) or (G, N, K)
constexpr int kWPerGroup = 4;  // w has a leading group axis

// Variants of `edense_forward` (kernels/elastic_matmul.py::VARIANTS).
constexpr int kSimt = 0, kTile = 1, kSkinny = 2;

// Contraction end of row r for an output tile starting at column c0: 0 when
// the row is past r_end or has no live output in the tile (past its m
// prefix, or the tile past its n prefix), else its k prefix clamped to
// [0, K].
__device__ __forceinline__ int row_kend(int r, int r_end, int M, int K, int N,
                                        int c0, const int* ka, const int* na,
                                        const int* ma) {
  if (r >= r_end) return 0;
  int g = r / M, m = r - g * M;
  if (m >= prefix(ma, g, M) || c0 >= prefix(na, g, N)) return 0;
  return min(max(prefix(ka, g, K), 0), K);
}

__device__ __forceinline__ float epilogue(float acc, int r, int c, int M,
                                          int N, const float* bias,
                                          long long b_gstride,
                                          const int* na, const int* ma,
                                          int act) {
  int g = r / M, m = r - g * M;
  if (m >= prefix(ma, g, M) || c >= prefix(na, g, N)) return 0.0f;
  if (bias != nullptr) acc += bias[(size_t)g * b_gstride + c];
  return apply_act(acc, act);
}

// Where a block's sum for (r, c) goes: straight through the epilogue into y
// when the contraction is not split, else raw into its chunk's partials.
__device__ __forceinline__ void store(float acc, int r, int c, int M, int N,
                                      int R, const float* bias,
                                      long long b_gstride, const int* na,
                                      const int* ma, int act, float* y,
                                      float* partial) {
  if (partial == nullptr)
    y[(size_t)r * N + c] =
        epilogue(acc, r, c, M, N, bias, b_gstride, na, ma, act);
  else
    partial[((size_t)blockIdx.z * R + r) * N + c] = acc;
}

// The row tile of block row blockIdx.y: over the flattened rows, or per
// group when each group has its own weights (or its own transposed x).
__device__ __forceinline__ void row_tile(int bm, int G, int M, int flags,
                                         int* r0, int* r_end) {
  if (flags & (kWPerGroup | kXTrans)) {
    const int tiles_m = (M + bm - 1) / bm;
    const int g = blockIdx.y / tiles_m;
    *r0 = g * M + (blockIdx.y - g * tiles_m) * bm;
    *r_end = g * M + M;
  } else {
    *r0 = blockIdx.y * bm;
    *r_end = G * M;
  }
}

// ---------------------------------------------------------------------------
// tile / skinny: 3×TF32 mma.sync, fed by a cp.async ring
// ---------------------------------------------------------------------------
constexpr int kBK = tf32x3::kStageK;  // contraction depth of a ring stage
using tf32x3::Permuted;
using tf32x3::Stage;

template <int BM, int BN, int STAGES, bool XT, bool WT>
constexpr int mma_smem_bytes() {
  constexpr bool P = Permuted<XT, WT>::value;
  return STAGES * (Stage<BM, !XT, P>::kFloats + Stage<BN, WT, P>::kFloats) *
         static_cast<int>(sizeof(float));
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES,
          int MIN_BLOCKS, bool XT, bool WT>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, MIN_BLOCKS)
edense_mma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ y,
                  float* __restrict__ partial, const int* __restrict__ ka,
                  const int* __restrict__ na, const int* __restrict__ ma,
                  int G, int M, int K, int N, int kchunk, int act, int flags,
                  long long w_gstride, long long b_gstride) {
  constexpr bool PERM = Permuted<XT, WT>::value;
  using SA = Stage<BM, !XT, PERM>;  // x: K-contiguous unless transposed
  using SB = Stage<BN, WT, PERM>;   // w: K-contiguous only when transposed
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(MT >= 1 && NT >= 1 && WTM % 16 == 0 && WTN % 8 == 0,
                "warp tile of whole m16n8 tiles");
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + STAGES * SA::kFloats;
  __shared__ long long xoff_row[BM];  // where row i's x values start
  __shared__ int kend_row[BM];
  __shared__ int kend_tile;

  const int R = G * M;
  int r0, r_end;
  row_tile(BM, G, M, flags, &r0, &r_end);
  const int c0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const float* wg = (flags & kWPerGroup)
                        ? w + (size_t)(r0 / M) * w_gstride : w;
  if (tid == 0) kend_tile = 0;
  __syncthreads();
  for (int i = tid; i < BM; i += kThreads) {
    const int r = r0 + i;
    const int e = row_kend(r, r_end, M, K, N, c0, ka, na, ma);
    kend_row[i] = e;
    long long off = 0;
    if (r < r_end) {
      const int g = r / M, m = r - g * M;
      off = XT ? (long long)g * K * M + m : (long long)r * K;
    }
    xoff_row[i] = off;
    if (e > 0) atomicMax(&kend_tile, e);
  }
  __syncthreads();
  const int k_lo = blockIdx.z * kchunk;
  const int k_hi = min(kend_tile, k_lo + kchunk);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  TC_DECL;  // a stage of math a tile; the x and w tiles of a stage 2 blocks

  // One ring stage: the x tile (BM × kBK) and the w tile (kBK × BN) at
  // contraction offset k0, in 16-byte copies along each operand's stored
  // rows; bytes past a row's k prefix, the chunk end, M or N read as zero.
  auto load_stage = [&](int stage, int k0) {
    float* as = As + stage * SA::kFloats;
    float* bs = Bs + stage * SB::kFloats;
    TC_DMA(2);
    for (int c = tid; c < BM * kBK / 4; c += kThreads) {
      int i, kk, bytes;
      const float* src = x;
      if (!XT) {  // x row i, k .. k + 3
        i = c / (kBK / 4);
        kk = (c % (kBK / 4)) * 4;
        const int k = k0 + kk;
        bytes = tf32x3::live_bytes(min(kend_row[i], k_hi) - k);
        if (bytes) src = x + xoff_row[i] + k;
      } else {    // xᵀ row k, x rows i .. i + 3 (one group: one k prefix)
        kk = c / (BM / 4);
        i = (c % (BM / 4)) * 4;
        const int k = k0 + kk;
        bytes = k < k_hi ? tf32x3::live_bytes(r_end - (r0 + i)) : 0;
        if (bytes) src = x + xoff_row[i] + (long long)k * M;
      }
      tf32x3::cp_async16(as + SA::at(i, kk), src, bytes);
    }
    for (int c = tid; c < BN * kBK / 4; c += kThreads) {
      int j, kk, bytes;
      const float* src = wg;
      if (!WT) {  // w row k, columns j .. j + 3
        kk = c / (BN / 4);
        j = (c % (BN / 4)) * 4;
        const int k = k0 + kk, col = c0 + j;
        bytes = k < k_hi ? tf32x3::live_bytes(N - col) : 0;
        if (bytes) src = wg + (size_t)k * N + col;
      } else {    // wᵀ row (column j), k .. k + 3
        j = c / (kBK / 4);
        kk = (c % (kBK / 4)) * 4;
        const int k = k0 + kk, col = c0 + j;
        bytes = col < N ? tf32x3::live_bytes(k_hi - k) : 0;
        if (bytes) src = wg + (size_t)col * K + k;
      }
      tf32x3::cp_async16(bs + SB::at(j, kk), src, bytes);
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WARPS_N) * WTM, wn = (warp % WARPS_N) * WTN;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_stage(s, k_lo + s * kBK);
    tf32x3::cp_async_commit();
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    tf32x3::cp_async_wait<STAGES - 2>();  // stage kt has landed
    __syncthreads();  // ... for every thread; stage kt - 1 is free again
    const int next = kt + STAGES - 1;
    if (next < n_tiles) load_stage(next % STAGES, k_lo + next * kBK);
    tf32x3::cp_async_commit();
    const float* as = As + (kt % STAGES) * SA::kFloats;
    const float* bs = Bs + (kt % STAGES) * SB::kFloats;
    tf32x3::stage_mma<BM, BN, MT, NT, XT, WT>(as, bs, wm, wn, g, t, acc);
    TC_TILES(1);
  }
  tf32x3::cp_async_wait<0>();
  TC_FLUSH(tid == 0);

  // epilogue: a row's group, m mask and n limit are read once; split-K
  // chunks write raw sums to their partials, the reduction applies them
  float* out = partial != nullptr ? partial + (size_t)blockIdx.z * R * N : y;
  const bool pairs = (N & 1) == 0;  // (r·N + c) even: 8-byte stores
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + wm + i * 16 + g + 8 * h;
      if (r >= r_end) continue;
      const int grp = r / M, m = r - grp * M;
      const int nlim = m < prefix(ma, grp, M) ? prefix(na, grp, N) : 0;
      const float* brow =
          bias != nullptr ? bias + (size_t)grp * b_gstride : nullptr;
      float* row_out = out + (size_t)r * N;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = c0 + wn + j * 8 + 2 * t;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (partial == nullptr) {
          v0 = c < nlim ? apply_act(v0 + (brow ? brow[c] : 0.0f), act)
                        : 0.0f;
          v1 = c + 1 < nlim
                   ? apply_act(v1 + (brow ? brow[c + 1] : 0.0f), act)
                   : 0.0f;
        }
        if (pairs && c + 1 < N) {
          *reinterpret_cast<float2*>(row_out + c) = make_float2(v0, v1);
        } else {
          if (c < N) row_out[c] = v0;
          if (c + 1 < N) row_out[c + 1] = v1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// simt: 64 x 64 output tile, 4 x 4 outputs per thread (unaligned rows)
// ---------------------------------------------------------------------------
constexpr int kSBM = 64, kSBN = 64, kSBK = 16, kTM = 4, kTN = 4;
constexpr int kSimtThreads = (kSBM / kTM) * (kSBN / kTN);

__global__ void __launch_bounds__(kSimtThreads)
edense_tiled_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y,
                    float* __restrict__ partial, const int* __restrict__ ka,
                    const int* __restrict__ na, const int* __restrict__ ma,
                    int G, int M, int K, int N, int kchunk, int act,
                    int flags, long long w_gstride, long long b_gstride) {
  __shared__ float xs[kSBK][kSBM + 1];  // transposed x tile, padded
  __shared__ float ws[kSBK][kSBN + 1];
  __shared__ size_t xoff_row[kSBM];     // where row i's x values start
  __shared__ int kend_row[kSBM];
  __shared__ int kend_tile;
  const int R = G * M;
  int r0, r_end;
  row_tile(kSBM, G, M, flags, &r0, &r_end);
  const int c0 = blockIdx.x * kSBN;
  const int tid = threadIdx.x;
  const bool x_trans = (flags & kXTrans) != 0;
  const bool w_trans = (flags & kWTrans) != 0;
  const float* wg = (flags & kWPerGroup)
                        ? w + (size_t)(r0 / M) * w_gstride : w;
  if (tid == 0) kend_tile = 0;
  __syncthreads();
  if (tid < kSBM) {
    const int r = r0 + tid;
    int e = row_kend(r, r_end, M, K, N, c0, ka, na, ma);
    kend_row[tid] = e;
    if (r < r_end) {
      const int g = r / M, m = r - g * M;
      xoff_row[tid] = x_trans ? (size_t)g * K * M + m : (size_t)r * K;
    }
    atomicMax(&kend_tile, e);
  }
  __syncthreads();
  const int k_lo = blockIdx.z * kchunk;
  const int k_hi = min(kend_tile, k_lo + kchunk);
  const int tx = tid % (kSBN / kTN), ty = tid / (kSBN / kTN);
  TC_DECL;  // a 16-deep step a tile; its x and w tiles 2 blocks

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kSBK) {
    TC_TILES(1);
    TC_DMA(2);
    // neighbouring threads take neighbouring addresses of the stored layout
    for (int e = tid; e < kSBM * kSBK; e += kSimtThreads) {
      int i, kk;
      if (x_trans) { i = e % kSBM; kk = e / kSBM; }
      else { i = e / kSBK; kk = e - i * kSBK; }
      const int k = k0 + kk;
      xs[kk][i] = (k < kend_row[i] && k < k_hi)
                      ? x[xoff_row[i] + (x_trans ? (size_t)k * M : k)]
                      : 0.0f;
    }
    for (int e = tid; e < kSBK * kSBN; e += kSimtThreads) {
      int kk, j;
      if (w_trans) { j = e / kSBK; kk = e - j * kSBK; }
      else { kk = e / kSBN; j = e - kk * kSBN; }
      const int k = k0 + kk, cc = c0 + j;
      ws[kk][j] = (k < k_hi && cc < N)
                      ? wg[w_trans ? (size_t)cc * K + k : (size_t)k * N + cc]
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[kk][tx + j * (kSBN / kTN)];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    int r = r0 + ty * kTM + i;
    if (r >= r_end) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      int cc = c0 + tx + j * (kSBN / kTN);
      if (cc < N) store(acc[i][j], r, cc, M, N, R, bias, b_gstride, na, ma,
                        act, y, partial);
    }
  }
  TC_FLUSH(tid == 0);
}

// ---------------------------------------------------------------------------
// split-K reduction: fixed-order sum of the chunks' partials + epilogue
// ---------------------------------------------------------------------------
__global__ void edense_reduce_kernel(const float* __restrict__ partial,
                                     int splits,
                                     const float* __restrict__ bias,
                                     long long b_gstride,
                                     float* __restrict__ y,
                                     const int* __restrict__ na,
                                     const int* __restrict__ ma, int R, int M,
                                     int N, int act) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)R * N;
  if (i >= total) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * total + i];
  const int r = static_cast<int>(i / N), c = static_cast<int>(i % N);
  y[i] = epilogue(s, r, c, M, N, bias, b_gstride, na, ma, act);
}

struct Args {
  const float* x;
  const float* w;
  const float* bias;
  float* y;
  float* partial;
  const int* ka;
  const int* na;
  const int* ma;
  int G, M, K, N, kchunk, act, flags;
  long long w_gstride, b_gstride;
};

int row_tiles(int G, int M, int flags, int bm) {
  if (flags & (kWPerGroup | kXTrans)) return G * ((M + bm - 1) / bm);
  return (G * M + bm - 1) / bm;
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES,
          int MIN_BLOCKS, bool XT, bool WT>
void launch_mma(const Args& a, int splits, cudaStream_t s) {
  constexpr int kSmem = mma_smem_bytes<BM, BN, STAGES, XT, WT>();
  auto kernel = edense_mma_kernel<BM, BN, WARPS_M, WARPS_N, STAGES,
                                  MIN_BLOCKS, XT, WT>;
  static bool configured = false;  // once per instantiation (one card)
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmem);
    configured = true;
  }
  dim3 grid((a.N + BN - 1) / BN, row_tiles(a.G, a.M, a.flags, BM), splits);
  kernel<<<grid, WARPS_M * WARPS_N * 32, kSmem, s>>>(
      a.x, a.w, a.bias, a.y, a.partial, a.ka, a.na, a.ma, a.G, a.M, a.K,
      a.N, a.kchunk, a.act, a.flags, a.w_gstride, a.b_gstride);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES,
          int MIN_BLOCKS>
void launch_layout(const Args& a, int splits, cudaStream_t s) {
  const bool xt = (a.flags & kXTrans) != 0, wt = (a.flags & kWTrans) != 0;
  if (xt && wt)
    launch_mma<BM, BN, WARPS_M, WARPS_N, STAGES, MIN_BLOCKS, true, true>(
        a, splits, s);
  else if (xt)
    launch_mma<BM, BN, WARPS_M, WARPS_N, STAGES, MIN_BLOCKS, true, false>(
        a, splits, s);
  else if (wt)
    launch_mma<BM, BN, WARPS_M, WARPS_N, STAGES, MIN_BLOCKS, false, true>(
        a, splits, s);
  else
    launch_mma<BM, BN, WARPS_M, WARPS_N, STAGES, MIN_BLOCKS, false, false>(
        a, splits, s);
}

}  // namespace

// C entry point, bound with ctypes. All pointers are device pointers; the
// wrapper has checked shapes, dtype (fp32), contiguity and device, and
// passes the plan of kernels/elastic_matmul.py::_plan: the variant (0 simt,
// 1 tile, 2 skinny), the row tile bm (64 for simt, 128 for tile, 16 / 32 /
// 64 for skinny), the number of contraction chunks and their length (a
// multiple of 32, and of 64 for simt); partial is a (splits, G·M, N) fp32
// scratch buffer, null when splits == 1. The tile and skinny variants take
// 16-byte-aligned operand rows only (the plan checks). A null ka / na / ma
// means the full extent for every group. flags: the layout flags above
// (kXTrans, kWTrans, kWPerGroup). w_gstride: the elements between two
// groups' weights (a layer of a client-stacked parameter is a strided
// view); x is contiguous or a transposed view of a contiguous tensor.
// b_gstride: the elements between two groups' bias rows (0: one (N,) bias
// shared by every group). Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int edense_forward(const float* x, const float* w,
                              const float* bias, float* y, float* partial,
                              const int* ka, const int* na, const int* ma,
                              int G, int M, int K, int N, int variant, int bm,
                              int splits, int kchunk, int act, int flags,
                              long long w_gstride, long long b_gstride,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = G * M;
  if (R <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (splits < 1 || (splits > 1 && partial == nullptr) || kchunk < 1 ||
      kchunk % (variant == kSimt ? kSBK : kBK) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w, bias, y, splits > 1 ? partial : nullptr, ka, na, ma,
               G, M, K, N, kchunk, act, flags, w_gstride, b_gstride};
  if (variant == kTile && bm == 128) {
    launch_layout<128, 128, 2, 4, 3, 2>(a, splits, s);
  } else if (variant == kSkinny && bm == 16) {
    launch_layout<16, 128, 1, 4, 3, 3>(a, splits, s);
  } else if (variant == kSkinny && bm == 32) {
    launch_layout<32, 128, 1, 4, 3, 3>(a, splits, s);
  } else if (variant == kSkinny && bm == 64) {
    launch_layout<64, 128, 1, 4, 3, 2>(a, splits, s);
  } else if (variant == kSimt && bm == kSBM) {
    dim3 grid((N + kSBN - 1) / kSBN, row_tiles(G, M, flags, kSBM), splits);
    edense_tiled_kernel<<<grid, kSimtThreads, 0, s>>>(
        x, w, bias, y, a.partial, ka, na, ma, G, M, K, N, kchunk, act, flags,
        w_gstride, b_gstride);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1) {
    const size_t total = (size_t)R * N;
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((total + threads - 1) /
                                                  threads);
    edense_reduce_kernel<<<blocks, threads, 0, s>>>(
        a.partial, splits, bias, b_gstride, y, na, ma, R, M, N, act);
  }
  return static_cast<int>(cudaGetLastError());
}
