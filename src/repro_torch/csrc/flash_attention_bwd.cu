// flash_attention_bwd — elastic flash attention backward, fp32, for sm_90a.
//
// Two kernels, the backward of csrc/flash_attention_fwd.cu:
//   * K3, dq, replaces the Pallas TPU kernel `_dq_kernel`
//     (src/repro/kernels/flash_attention.py, launched by `_bwd_call`);
//   * K4, dk / dv, replaces `_dkv_kernel` (same file) together with the
//     host-side sum of its per-query-head dk / dv over each GQA group.
// For q, do (B, Sq, H, D), k, v (B, Sk, KV, D), the forward's lse and
// delta = rowsum(do · o), both (B, H, Sq), they rebuild each probability
// from lse, as the reference's `_bwd_tile`:
//
//     s  = softcap(scale · q kᵀ)          p = exp(s − lse) on valid keys
//     dp = do vᵀ                          ds = p · (dp − delta) · s' · scale
//     dq = ds k        dk = dsᵀ q         dv = pᵀ do
//
// with s' = 1 − tanh²(scale · q kᵀ / cap) under the softcap (1 without),
// causal and sliding-window masks, the GQA mapping kv = h / (H / KV), and
// a per-batch runtime query-head prefix h_active ((B,) int32): heads at or
// past it write dq = 0, add nothing to dk / dv and issue no loads. Rows
// whose lse is NEG_INF (no valid key, or a skipped head) contribute
// nothing. The batch axis is the training path's client × sequence axis.
// Whole blocks that cannot contribute are skipped by the reference's
// `attn_block_contributes` predicate at each variant's own tile sizes. No
// atomics, and every sum runs in a fixed order: the output is
// deterministic.
//
// What bounds it on the H100. At the dense training shape (B = 16 rows of
// 128 tokens, H = 32, KV = 8, D = 128, causal: 4.227 M valid (query, key,
// head) triples) K3 moves q, do, dq, k, v, lse and delta once, 118.0 MB,
// 0.0352 ms at 3.35 TB/s, and does 6·D operations a triple, 0.0197 ms in
// 3×TF32 (three TF32 products an fp32 product at 495 TFLOP/s); K4 moves
// 101.2 MB, 0.0302 ms, and does 8·D a triple, 0.0262 ms. Both are bound
// by bytes on paper; in fp32 SIMT (67 TFLOP/s) by operations, 0.0485 and
// 0.0646 ms. Either way the work per block is a few small products, so
// what decides the time is how fast the tensor cores are fed from shared
// memory and how evenly the causal triangle spreads over the SMs.
//
// Two variants (`FLASH_BWD_VARIANTS` in kernels/flash_attention.py; the
// wrapper's `flash_bwd_plan` picks one from the shapes and alignment):
//
// mma — FlashAttention-2's backward on mma.sync m16n8k8 in 3×TF32
// (csrc/mma_tf32.cuh), split into its two deterministic halves. Each block
// has 8 warps in 4 pairs; the two warps of a pair own the same 16 rows and
// split the work of each step between them, so that each holds one
// product's accumulator (S or dP) and half of the output accumulators,
// and stays within the 128 registers a thread that two blocks an SM allow:
// at D = 128 a single warp holding all of K4's dK and dV (128 floats a
// thread) ran at the 255-register cap with 328 bytes spilled, and in 4
// warps an SM the latency of the in-core mma chains went unhidden.
//  * K3: a block per (head, batch, 64-query tile); the grid runs
//    head-fastest, as K2's does, so the heads of a GQA group share their
//    K / V tiles through L2, and the tiles with the most causal keys start
//    first. Q, dO, lse and delta of the tile are loaded once; K / V tiles
//    of 32 keys come in by cp.async, double-buffered at D ≤ 80 and
//    single-buffered from D = 128 on (two blocks an SM at 128). Per key block, the
//    pair's S warp takes S = Q Kᵀ and the dP warp dP = dO Vᵀ (over D ≤ 128:
//    at most 48 tensor-core accumulations, summed in the core by `mma3`);
//    the S warp hands p · s' · scale to the dP warp through shared memory,
//    which hands back dS = p · s' · scale · (dP − delta); then each adds
//    dS K into its half of dQ's columns by `mma3_add` (the sum runs over
//    every key, so each 8-deep step is promoted into fp32 adds).
//  * K4: a block per (KV head, batch, 64-key tile), the tiles with the
//    most causal queries first; K and V are loaded once. The block loops
//    over the group's live query heads (h < h_active[b]) and, for each,
//    over the 16-query blocks that contribute; Q, dO, lse and delta of a
//    block come in by cp.async into a two-deep ring (lse and delta staged
//    in shared memory: in this layout the queries are columns). Per query
//    block the pair's P warp takes Sᵀ = K Qᵀ, Pᵀ, and dV += Pᵀ dO; its dS
//    warp takes dPᵀ = V dOᵀ, reads p · s' · scale from the P warp, forms
//    dSᵀ and adds dK += dSᵀ Q. The accumulators persist across the group's
//    heads, in head order, so the group's sum is taken in the block and
//    (B, Sk, KV, D) is written directly.
//  * The accumulator of a product (rows g, g + 8; columns 2t, 2t + 1) is
//    the A fragment of the next product register for register, when the
//    next product's contraction takes k = 2t in slot t and 2t + 1 in slot
//    t + 4 (csrc/mma_tf32.cuh); the B operand of that product (K in K3, Q
//    and dO in K4) is read in the same order. The contractions over D
//    keep the native order (k = t, t + 4).
//  * One shared tile, two reads. K3 reads K as the B operand of S (rows of
//    the tile, along D) and of dQ (down the tile's rows, in the permuted
//    order); K4 reads Q and dO both ways. Every tile is stored row-major
//    at a row stride of D + 4 floats (≡ 4 mod 32 words at D a multiple of
//    32; D = 80 below) and read in 32-bit words: a fragment along the rows hits banks 4g + t, one down the rows
//    banks 8t + g — 32 distinct banks either way; the pairs' exchange
//    tiles are read and written in 64-bit words at a row stride ≡ 8 mod 32
//    (tests/test_torch_flash_bwd_mma.py checks every access). A pair hands
//    over through a named barrier of its 64 threads.
//  * A pair skips the math of a block its 16 rows cannot see (causal or
//    window), as K2's warps do.
//  * D = 256 (gemma, gemma2): one block of either kernel takes an SM's
//    shared memory (K3 209,920 B, K4 206,080 B), so the registers are
//    sized for one block (`MinBlocks`). S and dP (K3), Sᵀ and dPᵀ (K4)
//    sum each half of D in its own accumulator, each at most 48
//    tensor-core accumulations as at D = 128, added in fp32. K4's pair
//    would hold 128 floats a thread of dK or dV, what spilled at D = 128
//    in one warp; it takes two passes over its steps instead, each
//    summing half of D's columns (Sᵀ and dPᵀ recomputed in the second,
//    every column's sum in the same order).
//  * D = 80 (hubert-xlarge): the D ≤ 64 design — two K / V buffers in K3
//    (96,256 B), K4 70,912 B, two blocks an SM — with S / dP over 10
//    8-deep steps and each warp of a K3 pair summing 5 of dQ's 10 n-tiles
//    (D must be a multiple of 16). Its row stride, 84 floats, is ≡ 20 mod
//    32, not 4; what the fragment reads need is a stride that is an odd
//    multiple of 4 (banks 20g + t along a tile, 8t + g down it: 32
//    distinct either way). A row is 20 16-byte chunks, so `copy_rows`
//    numbers them in slots of 24 and no 8-thread phase straddles two rows.
//
// simt — the first design, for rows that are not 16-byte aligned
// (the cp.async copies need aligned rows): fp32 FMAs, 16 × 16 tiles, 8
// threads a row, its tiles in dynamic shared memory (`SimtTiles`). dq: a block per (batch, head, 16 query rows) looping
// over 16-key blocks, each thread scoring 2 keys and owning D/8 columns of
// dq; dk / dv: a block per (batch, KV head, 16 keys) looping over the
// group's heads and their 16-row query blocks.
#include <cuda_runtime.h>
#include <math.h>

#include "mma_tf32.cuh"
#include "tile_counters.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference NEG_INF

// ===========================================================================
// The simt variant: fp32 FMAs on 16 × 16 tiles
// ===========================================================================
constexpr int kBR = 16;                    // rows (queries or keys) a block
constexpr int kTPR = 8;                    // threads per row
constexpr int kBC = 16;                    // columns (keys or queries) a step
constexpr int kThreads = kBR * kTPR;
constexpr int kCPT = kBC / kTPR;           // columns scored per thread

// The reference's whole-block skip predicate for a query block starting at
// q0 and a key block starting at k0 (both kBR = kBC = 16 long).
__device__ __forceinline__ bool contributes(int q0, int k0, int causal,
                                            int window) {
  if (causal && k0 > q0 + kBR - 1) return false;
  if (window > 0 && k0 + kBC - 1 < q0 - (window - 1)) return false;
  return true;
}

// ds / p of one (query, key) pair from its two dot products.
struct PairGrad {
  float p, ds;
};

__device__ __forceinline__ PairGrad pair_grad(float qk, float dov, int qpos,
                                              int kpos, int Sq, int Sk,
                                              float lse, float delta,
                                              int causal, int window,
                                              float cap, float scale) {
  float s = qk * scale, dcap = 1.0f;
  if (cap > 0.0f) {
    const float t = tanhf(s / cap);
    s = cap * t;
    dcap = 1.0f - t * t;
  }
  bool ok = qpos < Sq && kpos < Sk && lse > kNegInf * 0.5f;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && (qpos - kpos < window);
  PairGrad g;
  g.p = ok ? expf(s - lse) : 0.0f;
  g.ds = g.p * (dov - delta) * dcap * scale;
  return g;
}

// Loads rows [r0, r0 + kBR) of head `hh` of a (B, S, NH, D) tensor into a
// padded shared tile, zeros past S.
template <int D>
__device__ __forceinline__ void load_rows(float (*dst)[D + 1],
                                          const float* __restrict__ src,
                                          int b, int r0, int S, int NH,
                                          int hh) {
  for (int e = threadIdx.x; e < kBR * D; e += kThreads) {
    const int i = e / D, d = e - i * D, r = r0 + i;
    dst[i][d] = r < S ? src[(((size_t)b * S + r) * NH + hh) * D + d] : 0.0f;
  }
}

template <int D>
__device__ __forceinline__ float dot_row(const float* a, const float* b) {
  float acc = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// ---------------------------------------------------------------------------
// K3, simt: block (query tile, head, batch); loop over key blocks
// ---------------------------------------------------------------------------
// The simt kernels' shared tiles live in dynamic shared memory: at
// D = 256 they take 66,880 B (dq) and 68,096 B (dk / dv), past the 48 KB
// of static shared memory a kernel may declare.
template <int D>
struct SimtTiles {
  static constexpr int kRow = D + 1;  // a padded row of q, do, k or v
  static constexpr int kDqBytes =
      (4 * kBR * kRow + kBR * (kBC + 1)) * static_cast<int>(sizeof(float));
  static constexpr int kDkvBytes =
      (4 * kBR * kRow + 2 * kBR * (kBC + 1) + 2 * kBC) *
      static_cast<int>(sizeof(float));
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                const int* __restrict__ ha, int Sq, int Sk, int H, int KV,
                int causal, int window, float cap, float scale) {
  constexpr int DPT = D / kTPR;
  extern __shared__ __align__(16) float smem[];
  float (*qs)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem);
  float (*dos)[D + 1] = qs + kBR;
  float (*ks)[D + 1] = dos + kBR;
  float (*vs)[D + 1] = ks + kBC;
  float (*dss)[kBC + 1] = reinterpret_cast<float (*)[kBC + 1]>(vs + kBC);

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid / kTPR, t = tid % kTPR;
  const int q0 = blockIdx.x * kBR, qpos = q0 + row;
  const bool q_ok = qpos < Sq;
  float* dq_row = dq + (((size_t)b * Sq + qpos) * H + h) * D;

  if (h >= ha[b]) {  // past the head prefix: the block is uniform, no sync
    if (q_ok) {
#pragma unroll
      for (int i = 0; i < DPT; ++i) dq_row[t + i * kTPR] = 0.0f;
    }
    return;
  }

  const int kvh = h / (H / KV);
  TC_DECL;  // a key block a tile; the Q and dO tiles, K and V a key block
  load_rows<D>(qs, q, b, q0, Sq, H, h);
  load_rows<D>(dos, dout, b, q0, Sq, H, h);
  TC_DMA(2);
  const size_t at = ((size_t)b * H + h) * Sq + qpos;
  const float lse_r = q_ok ? lse[at] : kNegInf;
  const float delta_r = q_ok ? delta[at] : 0.0f;

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.0f;

  const int nk = (Sk + kBC - 1) / kBC;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBC;
    if (causal && k0 > q0 + kBR - 1) break;
    if (!contributes(q0, k0, causal, window)) continue;
    __syncthreads();  // the previous step's readers of ks / vs are done
    load_rows<D>(ks, k, b, k0, Sk, KV, kvh);
    load_rows<D>(vs, v, b, k0, Sk, KV, kvh);
    TC_TILES(1);
    TC_DMA(2);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kCPT; ++jj) {
      const int j = t + jj * kTPR;
      const PairGrad g = pair_grad(dot_row<D>(qs[row], ks[j]),
                                   dot_row<D>(dos[row], vs[j]), qpos, k0 + j,
                                   Sq, Sk, lse_r, delta_r, causal, window,
                                   cap, scale);
      dss[row][j] = g.ds;
    }
    __syncwarp();  // a row's kTPR threads share one warp
    for (int j = 0; j < kBC; ++j) {
      const float ds = dss[row][j];
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(ds, ks[j][t + i * kTPR], acc[i]);
    }
    __syncwarp();  // dss is rewritten by the next step
  }
  if (q_ok) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) dq_row[t + i * kTPR] = acc[i];
  }
  TC_FLUSH(tid == 0);
}

// ---------------------------------------------------------------------------
// K4, simt: block (key tile, KV head, batch); loop over the group's query
// heads and their query blocks
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, const int* __restrict__ ha, int Sq,
                 int Sk, int H, int KV, int causal, int window, float cap,
                 float scale) {
  constexpr int DPT = D / kTPR;
  extern __shared__ __align__(16) float smem[];
  float (*ks)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem);
  float (*vs)[D + 1] = ks + kBR;
  float (*qs)[D + 1] = vs + kBR;
  float (*dos)[D + 1] = qs + kBC;
  float (*ps)[kBC + 1] =               // [key][query]
      reinterpret_cast<float (*)[kBC + 1]>(dos + kBC);
  float (*dss)[kBC + 1] = ps + kBR;
  float* lse_s = reinterpret_cast<float*>(dss + kBR);
  float* delta_s = lse_s + kBC;

  const int kvh = blockIdx.y, b = blockIdx.z, G = H / KV;
  const int tid = threadIdx.x, key = tid / kTPR, t = tid % kTPR;
  const int k0 = blockIdx.x * kBR, kpos = k0 + key;

  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  const int h_end = min(kvh * G + G, ha[b]);  // live heads of the group
  TC_DECL;  // a (head, query block) a tile; K and V once, Q and dO a tile
  if (kvh * G < h_end) {
    load_rows<D>(ks, k, b, k0, Sk, KV, kvh);
    load_rows<D>(vs, v, b, k0, Sk, KV, kvh);
    TC_DMA(2);
  }
  const int nq = (Sq + kBC - 1) / kBC;
  for (int h = kvh * G; h < h_end; ++h) {
    for (int qb = 0; qb < nq; ++qb) {
      const int q0 = qb * kBC;
      if (!contributes(q0, k0, causal, window)) continue;
      __syncthreads();  // the previous step's readers of qs / dos are done
      load_rows<D>(qs, q, b, q0, Sq, H, h);
      load_rows<D>(dos, dout, b, q0, Sq, H, h);
      TC_TILES(1);
      TC_DMA(2);
      if (tid < kBC) {
        const int qp = q0 + tid;
        const size_t at = ((size_t)b * H + h) * Sq + qp;
        lse_s[tid] = qp < Sq ? lse[at] : kNegInf;
        delta_s[tid] = qp < Sq ? delta[at] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int ii = 0; ii < kCPT; ++ii) {
        const int i = t + ii * kTPR;
        const PairGrad g = pair_grad(dot_row<D>(qs[i], ks[key]),
                                     dot_row<D>(dos[i], vs[key]), q0 + i,
                                     kpos, Sq, Sk, lse_s[i], delta_s[i],
                                     causal, window, cap, scale);
        ps[key][i] = g.p;
        dss[key][i] = g.ds;
      }
      __syncwarp();  // a key's kTPR threads share one warp
      for (int i = 0; i < kBC; ++i) {
        const float p = ps[key][i], ds = dss[key][i];
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          dv_acc[c] = fmaf(p, dos[i][t + c * kTPR], dv_acc[c]);
          dk_acc[c] = fmaf(ds, qs[i][t + c * kTPR], dk_acc[c]);
        }
      }
      __syncwarp();  // ps / dss are rewritten by the next step
    }
  }
  if (kpos < Sk) {
    const size_t off = (((size_t)b * Sk + kpos) * KV + kvh) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      dk[off + t + c * kTPR] = dk_acc[c];
      dv[off + t + c * kTPR] = dv_acc[c];
    }
  }
  TC_FLUSH(tid == 0);
}

// ===========================================================================
// The mma variant: 3×TF32 tensor-core tiles
// ===========================================================================
constexpr int kPairs = kThreads / 32;  // warp pairs a block: 4
constexpr int kDqBQ = 16 * kPairs;     // queries a dq block: 16 a pair
constexpr int kDqBK = 32;              // keys a dq step
constexpr int kDkvBK = 16 * kPairs;    // keys a dk / dv block: 16 a pair
constexpr int kDkvBQ = 16;             // queries a dk / dv step

// Every shared tile is row-major at a row stride of D + 4 floats: rows stay
// 16-byte aligned for cp.async, and the stride is an odd multiple of 4
// words (4 mod 32 at D a multiple of 32, 20 at D = 80), so both fragment
// reads below hit 32 distinct banks.
template <int D>
struct Row {
  static constexpr int kS = D + 4;
};

// Copies rows [r0, r0 + ROWS) of head hh of a (B, S, NH, D) tensor into a
// shared tile by 16-byte cp.async copies of the block's NT threads; rows
// past S are zero-filled without a read. A row's chunks are numbered in
// slots of a multiple of 8 (`kCP`), so that no 8-thread phase of the copy
// straddles two rows: at D = 80 (20 chunks a row) a phase that did would
// write rows r and r + 1 on 4 common banks. At D a multiple of 32 the slots
// are the chunks.
template <int D, int ROWS, int NT = kThreads>
__device__ __forceinline__ void copy_rows(float* dst,
                                          const float* __restrict__ src,
                                          int b, int r0, int S, int NH,
                                          int hh) {
  constexpr int kC = D / 4;                 // 16-byte chunks a row
  constexpr int kCP = (kC + 7) / 8 * 8;     // their slots
  for (int c = threadIdx.x; c < ROWS * kCP; c += NT) {
    const int i = c / kCP, d = (c - i * kCP) * 4, r = r0 + i;
    if (kCP != kC && d >= D) continue;
    const float* p = src;
    int bytes = 0;
    if (r < S) {
      p = src + (((size_t)b * S + r) * NH + hh) * D + d;
      bytes = 16;
    }
    tf32x3::cp_async16(dst + i * Row<D>::kS + d, p, bytes);
  }
}

// The A fragment of rows [r, r + 16) of a tile, contracting along its
// columns c .. c + 7 in the native order (a0 (g, c + t), a1 (g + 8, c + t),
// a2 (g, c + t + 4), a3 (g + 8, c + t + 4)); words 4g + t: distinct banks.
template <int S>
__device__ __forceinline__ void load_a(const float* tile, int r, int c,
                                       int g, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float* p = tile + (r + g) * S + c + t;
  tf32x3::split(p[0], hi[0], lo[0]);
  tf32x3::split(p[8 * S], hi[1], lo[1]);
  tf32x3::split(p[4], hi[2], lo[2]);
  tf32x3::split(p[8 * S + 4], hi[3], lo[3]);
}

// The B fragment of rows [n, n + 8) of a tile as the columns of a product
// that contracts along the tile's columns c .. c + 7 in the native order
// (b0 (k = c + t, n + g), b1 (k = c + t + 4, n + g)); words 4g + t.
template <int S>
__device__ __forceinline__ void load_b_along(const float* tile, int n, int c,
                                             int g, int t, uint32_t (&hi)[2],
                                             uint32_t (&lo)[2]) {
  const float* p = tile + (n + g) * S + c + t;
  tf32x3::split(p[0], hi[0], lo[0]);
  tf32x3::split(p[4], hi[1], lo[1]);
}

// The B fragment of columns [n, n + 8) of a tile for a product that
// contracts down the tile's rows k .. k + 7 in the permuted order (b0 at
// row k + 2t, b1 at row k + 2t + 1, column n + g); words 8t + g.
template <int S>
__device__ __forceinline__ void load_b_down(const float* tile, int k, int n,
                                            int g, int t, uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  const float* p = tile + (k + 2 * t) * S + n + g;
  tf32x3::split(p[0], hi[0], lo[0]);
  tf32x3::split(p[S], hi[1], lo[1]);
}

// An m16n8 accumulator (c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3
// (g + 8, 2t + 1)) as the A fragment of a product over its 8 columns in the
// permuted order (column 2t in slot t, 2t + 1 in slot t + 4).
__device__ __forceinline__ void acc_as_a(const float (&c)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  tf32x3::split(c[0], hi[0], lo[0]);
  tf32x3::split(c[2], hi[1], lo[1]);
  tf32x3::split(c[1], hi[2], lo[2]);
  tf32x3::split(c[3], hi[3], lo[3]);
}

// p of one (query, key) pair from its accumulated score, and p · s' · scale
// in `pd` (the reference's `_bwd_tile`; the pair's other warp forms
// ds = pd · (dp − delta)). `ok`: the pair is valid and its row live.
__device__ __forceinline__ float prob(float s, bool ok, float lse, float cap,
                                      float scale, float& pd) {
  float sc = s * scale, dcap = 1.0f;
  if (cap > 0.0f) {
    const float th = tanhf(sc / cap);
    sc = cap * th;
    dcap = 1.0f - th * th;
  }
  const float p = ok ? expf(sc - lse) : 0.0f;
  pd = p * dcap * scale;
  return p;
}

// ---------------------------------------------------------------------------
// K3, mma: block (head, batch, query tile); loop over 32-key blocks. Two
// warps per 16 queries: an S warp (S, P) and a dP warp (dP, dS), each
// summing half of dQ's columns (D/4 registers a thread), so that an SM
// holds two blocks of 8 warps.
// ---------------------------------------------------------------------------
constexpr int kPairWarps = 2 * kPairs;
constexpr int kPairThreads = 32 * kPairWarps;

// Blocks an SM that a kernel's registers are sized for: two, except at
// D = 256, where one block takes most of an SM's shared memory and its
// threads may use up to 255 registers.
template <int D>
struct MinBlocks {
  static constexpr int v = D >= 256 ? 1 : 2;
};

template <int D>
struct DqTiles {
  static constexpr int kS = Row<D>::kS;
  static constexpr int kNBuf = D >= 128 ? 1 : 2;  // K / V buffers, as K2
  static constexpr int kQ = kDqBQ * kS;           // Q and dO: floats each
  static constexpr int kK = kDqBK * kS;           // K and V: each, a buffer
  // p · s' · scale from the S warps, then dS from the dP warps, [query]
  // [key] at a row stride ≡ 8 mod 32 words
  static constexpr int kXS = kDqBK + 8;
  static constexpr int kX = kDqBQ * kXS;
  static constexpr int kBytes =
      (2 * kQ + 2 * kNBuf * kK + kX) * static_cast<int>(sizeof(float));
};

// Named barrier `id` over `count` threads: the producer arrives, the
// consumer waits; shared-memory writes before the arrive are visible after
// the wait.
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kPairThreads, MinBlocks<D>::v)
flash_dq_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    const int* __restrict__ ha, int Sq, int Sk, int H, int KV,
                    int causal, int window, float cap, float scale) {
  using L = DqTiles<D>;
  constexpr int kS = L::kS, kKT = kDqBK / 8, kXS = L::kXS;
  constexpr int kHT = D / 16;  // n-tiles of the warp's half of dQ
  static_assert(D % 16 == 0, "a warp pair splits dQ's n-tiles in halves");
  // past D = 128 S's (dP's) two halves of D sum in two accumulators, each
  // at most 48 tensor-core accumulations as at D = 128, added in fp32
  constexpr bool kTwoHalves = D > 128;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Os = Qs + L::kQ;  // dO
  float* Ks = Os + L::kQ;
  float* Vs = Ks + L::kNBuf * L::kK;
  float* xs = Vs + L::kNBuf * L::kK;

  const int h = blockIdx.x, b = blockIdx.y;
  // the last query tiles, which see the most keys under a causal mask,
  // first (the slowest grid axis)
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kDqBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool s_warp = warp < kPairs;     // else the pair's dP warp
  const int pair = warp % kPairs;
  const int qr = pair * 16;              // the pair's first row in the tile

  if (h >= ha[b]) {  // past the head prefix: the block is uniform, no sync
    for (int e = tid; e < kDqBQ * D; e += kPairThreads) {
      const int qp = q0 + e / D;
      if (qp < Sq) dq[(((size_t)b * Sq + qp) * H + h) * D + e % D] = 0.0f;
    }
    return;
  }
  const int kvh = h / (H / KV);

  // the key blocks that can contribute (the reference predicate at bq = 64,
  // bk = 32)
  const int nk = (Sk + kDqBK - 1) / kDqBK;
  int kb_lo = 0;
  if (window > 0) {
    const int lo = q0 - (window - 1);
    kb_lo = lo > 0 ? lo / kDqBK : 0;
  }
  const int kb_hi = causal ? min(nk, (q0 + kDqBQ - 1) / kDqBK + 1) : nk;

  TC_DECL;  // a key block a tile; the Q and dO tiles, K and V a key block
  copy_rows<D, kDqBQ, kPairThreads>(Qs, q, b, q0, Sq, H, h);
  copy_rows<D, kDqBQ, kPairThreads>(Os, dout, b, q0, Sq, H, h);
  TC_DMA(2);
  auto load_kv = [&](int buf, int kb) {
    TC_DMA(2);
    copy_rows<D, kDqBK, kPairThreads>(Ks + buf * L::kK, k, b, kb * kDqBK,
                                      Sk, KV, kvh);
    copy_rows<D, kDqBK, kPairThreads>(Vs + buf * L::kK, v, b, kb * kDqBK,
                                      Sk, KV, kvh);
  };
  if (L::kNBuf == 2 && kb_lo < kb_hi) load_kv(0, kb_lo);
  tf32x3::cp_async_commit();

  const int qr0 = q0 + qr;  // the pair's first row
  const int row_a = qr0 + g, row_b = row_a + 8;
  const size_t at = ((size_t)b * H + h) * Sq;
  const float lse_a = row_a < Sq ? lse[at + row_a] : kNegInf;
  const float lse_b = row_b < Sq ? lse[at + row_b] : kNegInf;
  const float dl_a = row_a < Sq ? delta[at + row_a] : 0.0f;
  const float dl_b = row_b < Sq ? delta[at + row_b] : 0.0f;
  const bool live_a = lse_a > kNegInf * 0.5f, live_b = lse_b > kNegInf * 0.5f;
  const int n_lo = s_warp ? 0 : kHT;  // the warp's first n-tile of dQ
  // this thread's exchange words: rows g and g + 8 of the pair, keys 2t,
  // 2t + 1 of each 8-key tile
  float* xw = xs + (qr + g) * kXS + 2 * t;

  float acc[kHT][4];
#pragma unroll
  for (int n = 0; n < kHT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int kb = kb_lo, it = 0; kb < kb_hi; ++kb, ++it) {
    const int buf = L::kNBuf == 2 ? it & 1 : 0;
    TC_TILES(1);
    if (L::kNBuf == 2) {
      if (kb + 1 < kb_hi) load_kv(buf ^ 1, kb + 1);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();  // Q, dO and this block's K / V landed
    } else {
      load_kv(0, kb);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kb * kDqBK;
    const bool skip = qr0 >= Sq || (causal && k0 > qr0 + 15) ||
                      (window > 0 && k0 + kDqBK - 1 < qr0 - (window - 1));
    if (!skip) {  // uniform over the pair
      const float* ks = Ks + buf * L::kK;
      // S = Q Kᵀ (S warp) or dP = dO Vᵀ (dP warp), over D
      const float* at_ = s_warp ? Qs : Os;
      const float* bt = s_warp ? ks : Vs + buf * L::kK;
      float s[kKT][4], s2[kKT][4];
#pragma unroll
      for (int j = 0; j < kKT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.0f;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 8) {
        uint32_t ah[4], al[4];
        load_a<kS>(at_, qr, d0, g, t, ah, al);
#pragma unroll
        for (int j = 0; j < kKT; ++j) {
          uint32_t bh[2], bl[2];
          load_b_along<kS>(bt, j * 8, d0, g, t, bh, bl);
          tf32x3::mma3((kTwoHalves && d0 >= D / 2) ? s2[j] : s[j], ah, al,
                       bh, bl);
        }
      }
      if (kTwoHalves) {
#pragma unroll
        for (int j = 0; j < kKT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];
      }
      if (s_warp) {
        // P (rows g, g + 8; keys 2t, 2t + 1) as p · s' · scale for the dP
        // warp, which returns dS
#pragma unroll
        for (int j = 0; j < kKT; ++j) {
          float pd[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + j * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            bool ok = kp < Sk && (e < 2 ? live_a : live_b);
            if (causal) ok = ok && kp <= row;
            if (window > 0) ok = ok && row - kp < window;
            prob(s[j][e], ok, e < 2 ? lse_a : lse_b, cap, scale, pd[e]);
          }
          *reinterpret_cast<float2*>(xw + j * 8) = make_float2(pd[0], pd[1]);
          *reinterpret_cast<float2*>(xw + 8 * kXS + j * 8) =
              make_float2(pd[2], pd[3]);
        }
        bar_arrive(1 + pair, 2 * 32);
        bar_sync(1 + kPairs + pair, 2 * 32);  // dS landed
#pragma unroll
        for (int j = 0; j < kKT; ++j) {
          const float2 da = *reinterpret_cast<const float2*>(xw + j * 8);
          const float2 db =
              *reinterpret_cast<const float2*>(xw + 8 * kXS + j * 8);
          s[j][0] = da.x;
          s[j][1] = da.y;
          s[j][2] = db.x;
          s[j][3] = db.y;
        }
      } else {
        bar_sync(1 + pair, 2 * 32);  // p · s' · scale landed
        // dS = p s' scale (dP − delta), for both warps of the pair
#pragma unroll
        for (int j = 0; j < kKT; ++j) {
          const float2 pa = *reinterpret_cast<const float2*>(xw + j * 8);
          const float2 pb =
              *reinterpret_cast<const float2*>(xw + 8 * kXS + j * 8);
          s[j][0] = pa.x * (s[j][0] - dl_a);
          s[j][1] = pa.y * (s[j][1] - dl_a);
          s[j][2] = pb.x * (s[j][2] - dl_b);
          s[j][3] = pb.y * (s[j][3] - dl_b);
          *reinterpret_cast<float2*>(xw + j * 8) =
              make_float2(s[j][0], s[j][1]);
          *reinterpret_cast<float2*>(xw + 8 * kXS + j * 8) =
              make_float2(s[j][2], s[j][3]);
        }
        bar_arrive(1 + kPairs + pair, 2 * 32);
      }
      // the warp's half of dQ += dS K over the block's keys: dS is the A
      // fragment as it is
#pragma unroll
      for (int j = 0; j < kKT; ++j) {
        uint32_t ah[4], al[4];
        acc_as_a(s[j], ah, al);
#pragma unroll
        for (int n = 0; n < kHT; ++n) {
          uint32_t bh[2], bl[2];
          load_b_down<kS>(ks, j * 8, (n_lo + n) * 8, g, t, bh, bl);
          tf32x3::mma3_add(acc[n], ah, al, bh, bl);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer and xs
  }
  tf32x3::cp_async_wait<0>();
  TC_FLUSH(tid == 0);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_b : row_a;
    if (row >= Sq) continue;
    float* out = dq + (((size_t)b * Sq + row) * H + h) * D + n_lo * 8 + 2 * t;
#pragma unroll
    for (int n = 0; n < kHT; ++n)
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// K4, mma: block (KV head, batch, key tile); loop over the group's live
// query heads and their BQ-query blocks. Two warps per 16 keys: a P warp
// (Sᵀ, Pᵀ, dV) and a dS warp (dPᵀ, dSᵀ, dK), so that each holds one
// accumulator of 16 keys × D (D/2 registers a thread) and an SM two blocks
// of 8 warps.
// ---------------------------------------------------------------------------
template <int D>
struct DkvTiles {
  static constexpr int BQ = kDkvBQ;
  static constexpr int kS = Row<D>::kS;
  static constexpr int kK = kDkvBK * kS;       // K and V: floats each
  static constexpr int kQ = BQ * kS;           // Q and dO: each, a buffer
  static constexpr int kBuf = 2 * kQ + 2 * BQ;  // a buffer: Q, dO, lse, delta
  // p · s' · scale from the P warps to the dS warps, [key][query] at a row
  // stride ≡ 8 mod 32 words: a half warp's 64-bit words hit distinct banks
  static constexpr int kXS = BQ + 8;
  static constexpr int kX = kDkvBK * kXS;
  static constexpr int kBytes =  // K, V, a two-deep ring, the exchange
      (2 * kK + 2 * kBuf + kX) * static_cast<int>(sizeof(float));
};

template <int D>
__global__ void __launch_bounds__(kPairThreads, MinBlocks<D>::v)
flash_dkv_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, const int* __restrict__ ha,
                     int Sq, int Sk, int H, int KV, int causal, int window,
                     float cap, float scale) {
  using L = DkvTiles<D>;
  constexpr int BQ = L::BQ;
  constexpr int kS = L::kS, kNT = D / 8, kQT = BQ / 8, kXS = L::kXS;
  // at D = 256 the pair's accumulators (16 keys × D, 128 floats a thread)
  // are taken in two passes over the steps, each summing half of D's
  // columns (64 floats a thread, as at D = 128): Sᵀ and dPᵀ are recomputed
  // in the second pass, and every column's sum keeps its order
  constexpr int kPasses = D > 128 ? 2 : 1, kNP = kNT / kPasses;
  constexpr bool kTwoHalves = D > 128;  // Sᵀ / dPᵀ in two chains, as K3
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + L::kK;
  float* ring = Vs + L::kK;
  float* xp = ring + 2 * L::kBuf;

  // the first key tiles, which see the most queries under a causal mask,
  // first (the slowest grid axis)
  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kDkvBK;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool p_warp = warp < kPairs;  // else the pair's dS warp
  const int pair = warp % kPairs;
  const int kr0 = pair * 16;          // the pair's first key in the tile
  const int h_lo = kvh * G, h_hi = min(h_lo + G, ha[b]);  // live heads

  if (h_lo >= h_hi) {  // no live head in the group: zeros, no loads
    for (int e = tid; e < kDkvBK * D; e += kPairThreads) {
      const int kp = k0 + e / D;
      if (kp < Sk) {
        const size_t off = (((size_t)b * Sk + kp) * KV + kvh) * D + e % D;
        dk[off] = 0.0f;
        dv[off] = 0.0f;
      }
    }
    return;
  }

  // the query blocks that can contribute (the reference predicate at
  // bq = BQ, bk = 64; k0 is a multiple of BQ)
  const int nq = (Sq + BQ - 1) / BQ;
  const int qb_lo = causal ? min(nq, k0 / BQ) : 0;
  const int qb_hi =
      window > 0 ? min(nq, (k0 + kDkvBK - 1 + window - 1) / BQ + 1) : nq;
  const int n_qb = max(0, qb_hi - qb_lo);
  const int steps = (h_hi - h_lo) * n_qb;  // heads outer, in order

  TC_DECL;  // a (head, query block) a tile each pass; K and V once, the
            // Q and dO tiles of a step (lse and delta are narrow)
  copy_rows<D, kDkvBK, kPairThreads>(Ks, k, b, k0, Sk, KV, kvh);
  copy_rows<D, kDkvBK, kPairThreads>(Vs, v, b, k0, Sk, KV, kvh);
  TC_DMA(2);
  auto load_q = [&](int buf, int step) {
    const int h = h_lo + step / n_qb, q0 = (qb_lo + step % n_qb) * BQ;
    TC_DMA(2);
    float* dst = ring + buf * L::kBuf;
    copy_rows<D, BQ, kPairThreads>(dst, q, b, q0, Sq, H, h);
    copy_rows<D, BQ, kPairThreads>(dst + L::kQ, dout, b, q0, Sq, H, h);
    if (tid < BQ) {
      const int qp = q0 + tid;
      const size_t at = ((size_t)b * H + h) * Sq + qp;
      const bool in = qp < Sq;
      tf32x3::cp_async4(dst + 2 * L::kQ + tid, in ? lse + at : lse,
                        in ? 4 : 0);
      tf32x3::cp_async4(dst + 2 * L::kQ + BQ + tid, in ? delta + at : delta,
                        in ? 4 : 0);
    }
  };
  const int kw0 = k0 + kr0;  // the pair's first key
  const int key_a = kw0 + g, key_b = key_a + 8;
  // this thread's p · s' · scale words: rows g and g + 8 of the pair,
  // columns 2t, 2t + 1 of each 8-query tile
  float* xw = xp + (kr0 + g) * kXS + 2 * t;

  for (int pass = 0; pass < kPasses; ++pass) {
  const int n0 = pass * kNP;  // the pass's first n-tile of dK / dV
  // the ring is free: every warp passed the last step's __syncthreads
  if (steps > 0) load_q(0, 0);
  tf32x3::cp_async_commit();
  float acc[kNP][4];  // dV (P warp) or dK (dS warp), 16 keys × D / kPasses
#pragma unroll
  for (int n = 0; n < kNP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    TC_TILES(1);
    if (step + 1 < steps) load_q(buf ^ 1, step + 1);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();  // K, V and this step's block landed
    __syncthreads();
    const int q0 = (qb_lo + step % n_qb) * BQ;
    const bool skip = kw0 >= Sk || (causal && q0 + BQ - 1 < kw0) ||
                      (window > 0 && q0 - (kw0 + 15) >= window);
    if (!skip) {  // uniform over the pair
      const float* qs = ring + buf * L::kBuf;
      const float* os = qs + L::kQ;  // dO
      // Sᵀ = K Qᵀ (P warp) or dPᵀ = V dOᵀ (dS warp), over D
      const float* at = p_warp ? Ks : Vs;
      const float* bt = p_warp ? qs : os;
      float sp[kQT][4], sp2[kQT][4];
#pragma unroll
      for (int j = 0; j < kQT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[j][e] = sp2[j][e] = 0.0f;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 8) {
        uint32_t ah[4], al[4];
        load_a<kS>(at, kr0, d0, g, t, ah, al);
#pragma unroll
        for (int j = 0; j < kQT; ++j) {
          uint32_t bh[2], bl[2];
          load_b_along<kS>(bt, j * 8, d0, g, t, bh, bl);
          tf32x3::mma3((kTwoHalves && d0 >= D / 2) ? sp2[j] : sp[j], ah,
                       al, bh, bl);
        }
      }
      if (kTwoHalves) {
#pragma unroll
        for (int j = 0; j < kQT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sp[j][e] += sp2[j][e];
      }
      if (p_warp) {
        // Pᵀ (keys g, g + 8; queries 2t, 2t + 1), and p · s' · scale for
        // the dS warp
        const float* lse_s = os + L::kQ;
#pragma unroll
        for (int j = 0; j < kQT; ++j) {
          float pd[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = j * 8 + 2 * t + (e & 1), qp = q0 + c;
            const int kp = e < 2 ? key_a : key_b;
            const float l = lse_s[c];
            bool ok = kp < Sk && qp < Sq && l > kNegInf * 0.5f;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && qp - kp < window;
            sp[j][e] = prob(sp[j][e], ok, l, cap, scale, pd[e]);
          }
          *reinterpret_cast<float2*>(xw + j * 8) = make_float2(pd[0], pd[1]);
          *reinterpret_cast<float2*>(xw + 8 * kXS + j * 8) =
              make_float2(pd[2], pd[3]);
        }
        bar_arrive(1 + pair, 2 * 32);
        // dV += Pᵀ dO over the block's queries
#pragma unroll
        for (int j = 0; j < kQT; ++j) {
          uint32_t ah[4], al[4];
          acc_as_a(sp[j], ah, al);
#pragma unroll
          for (int n = 0; n < kNP; ++n) {
            uint32_t bh[2], bl[2];
            load_b_down<kS>(os, j * 8, (n0 + n) * 8, g, t, bh, bl);
            tf32x3::mma3_add(acc[n], ah, al, bh, bl);
          }
        }
      } else {
        const float* dl_s = os + L::kQ + BQ;
        bar_sync(1 + pair, 2 * 32);  // the P warp's words landed
        // dSᵀ = Pᵀ (dPᵀ − delta) s' scale, then dK += dSᵀ Q
#pragma unroll
        for (int j = 0; j < kQT; ++j) {
          const float2 pa = *reinterpret_cast<const float2*>(xw + j * 8);
          const float2 pb =
              *reinterpret_cast<const float2*>(xw + 8 * kXS + j * 8);
          const int c = j * 8 + 2 * t;
          sp[j][0] = pa.x * (sp[j][0] - dl_s[c]);
          sp[j][1] = pa.y * (sp[j][1] - dl_s[c + 1]);
          sp[j][2] = pb.x * (sp[j][2] - dl_s[c]);
          sp[j][3] = pb.y * (sp[j][3] - dl_s[c + 1]);
          uint32_t ah[4], al[4];
          acc_as_a(sp[j], ah, al);
#pragma unroll
          for (int n = 0; n < kNP; ++n) {
            uint32_t bh[2], bl[2];
            load_b_down<kS>(qs, j * 8, (n0 + n) * 8, g, t, bh, bl);
            tf32x3::mma3_add(acc[n], ah, al, bh, bl);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer and xp
  }
  tf32x3::cp_async_wait<0>();

  float* out = p_warp ? dv : dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = r ? key_b : key_a;
    if (kp >= Sk) continue;
    const size_t off =
        (((size_t)b * Sk + kp) * KV + kvh) * D + n0 * 8 + 2 * t;
#pragma unroll
    for (int n = 0; n < kNP; ++n)
      *reinterpret_cast<float2*>(out + off + n * 8) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
  }  // pass
  TC_FLUSH(tid == 0);
}

// Each mma kernel's dynamic shared memory limit is raised once per
// instantiation (one card) before its first launch.
template <typename Kernel>
void allow_smem(Kernel kernel, int bytes, bool& configured) {
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    configured = true;
  }
}

template <int D>
void launch_dq_mma(dim3 grid, cudaStream_t s, const float* q, const float* k,
                   const float* v, const float* dout, const float* lse,
                   const float* delta, float* dq, const int* ha, int Sq,
                   int Sk, int H, int KV, int causal, int window, float cap,
                   float scale) {
  static bool configured = false;
  allow_smem(flash_dq_mma_kernel<D>, DqTiles<D>::kBytes, configured);
  flash_dq_mma_kernel<D><<<grid, kPairThreads, DqTiles<D>::kBytes, s>>>(
      q, k, v, dout, lse, delta, dq, ha, Sq, Sk, H, KV, causal, window, cap,
      scale);
}

template <int D>
void launch_dkv_mma(dim3 grid, cudaStream_t s, const float* q,
                    const float* k, const float* v, const float* dout,
                    const float* lse, const float* delta, float* dk,
                    float* dv, const int* ha, int Sq, int Sk, int H, int KV,
                    int causal, int window, float cap, float scale) {
  static bool configured = false;
  allow_smem(flash_dkv_mma_kernel<D>, DkvTiles<D>::kBytes, configured);
  flash_dkv_mma_kernel<D><<<grid, kPairThreads, DkvTiles<D>::kBytes, s>>>(
      q, k, v, dout, lse, delta, dk, dv, ha, Sq, Sk, H, KV, causal, window,
      cap, scale);
}

template <int D>
void launch_dq_simt(dim3 grid, cudaStream_t s, const float* q,
                    const float* k, const float* v, const float* dout,
                    const float* lse, const float* delta, float* dq,
                    const int* ha, int Sq, int Sk, int H, int KV, int causal,
                    int window, float cap, float scale) {
  static bool configured = false;
  allow_smem(flash_dq_kernel<D>, SimtTiles<D>::kDqBytes, configured);
  flash_dq_kernel<D><<<grid, kThreads, SimtTiles<D>::kDqBytes, s>>>(
      q, k, v, dout, lse, delta, dq, ha, Sq, Sk, H, KV, causal, window, cap,
      scale);
}

template <int D>
void launch_dkv_simt(dim3 grid, cudaStream_t s, const float* q,
                     const float* k, const float* v, const float* dout,
                     const float* lse, const float* delta, float* dk,
                     float* dv, const int* ha, int Sq, int Sk, int H, int KV,
                     int causal, int window, float cap, float scale) {
  static bool configured = false;
  allow_smem(flash_dkv_kernel<D>, SimtTiles<D>::kDkvBytes, configured);
  flash_dkv_kernel<D><<<grid, kThreads, SimtTiles<D>::kDkvBytes, s>>>(
      q, k, v, dout, lse, delta, dk, dv, ha, Sq, Sk, H, KV, causal, window,
      cap, scale);
}

}  // namespace

// C entry points, bound with ctypes. All pointers are device pointers; the
// wrapper has checked shapes, dtype (fp32), contiguity and device, and
// computed delta; for the mma variant q, k, v and dout start 16-byte
// aligned. window <= 0 means no window; cap <= 0 means no softcap.
// variant: 0 simt, 1 mma (the order of FLASH_BWD_VARIANTS). Each returns
// cudaGetLastError() after its launch (0 = launched).
extern "C" int flash_attention_dq(const float* q, const float* k,
                                  const float* v, const float* dout,
                                  const float* lse, const float* delta,
                                  float* dq, const int* ha, int B, int Sq,
                                  int Sk, int H, int KV, int D, int causal,
                                  int window, float cap, float scale,
                                  int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || H <= 0) return cudaGetLastError();
  if (variant == 1) {
    dim3 grid(H, B, (Sq + kDqBQ - 1) / kDqBQ);
#define FLASH_DQ_MMA(DIM)                                                 \
  launch_dq_mma<DIM>(grid, s, q, k, v, dout, lse, delta, dq, ha, Sq, Sk,  \
                     H, KV, causal, window, cap, scale)
    switch (D) {
      case 32: FLASH_DQ_MMA(32); break;
      case 64: FLASH_DQ_MMA(64); break;
      case 80: FLASH_DQ_MMA(80); break;
      case 128: FLASH_DQ_MMA(128); break;
      case 256: FLASH_DQ_MMA(256); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FLASH_DQ_MMA
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((Sq + kBR - 1) / kBR, H, B);
#define FLASH_DQ(DIM)                                                     \
  launch_dq_simt<DIM>(grid, s, q, k, v, dout, lse, delta, dq, ha, Sq, Sk, \
                      H, KV, causal, window, cap, scale)
  switch (D) {
    case 32: FLASH_DQ(32); break;
    case 64: FLASH_DQ(64); break;
    case 80: FLASH_DQ(80); break;
    case 128: FLASH_DQ(128); break;
    case 256: FLASH_DQ(256); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_DQ
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_dkv(const float* q, const float* k,
                                   const float* v, const float* dout,
                                   const float* lse, const float* delta,
                                   float* dk, float* dv, const int* ha,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int D, int causal, int window, float cap,
                                   float scale, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sk <= 0 || KV <= 0) return cudaGetLastError();
  if (variant == 1) {
    dim3 grid(KV, B, (Sk + kDkvBK - 1) / kDkvBK);
#define FLASH_DKV_MMA(DIM)                                                \
  launch_dkv_mma<DIM>(grid, s, q, k, v, dout, lse, delta, dk, dv, ha, Sq, \
                      Sk, H, KV, causal, window, cap, scale)
    switch (D) {
      case 32: FLASH_DKV_MMA(32); break;
      case 64: FLASH_DKV_MMA(64); break;
      case 80: FLASH_DKV_MMA(80); break;
      case 128: FLASH_DKV_MMA(128); break;
      case 256: FLASH_DKV_MMA(256); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FLASH_DKV_MMA
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((Sk + kBR - 1) / kBR, KV, B);
#define FLASH_DKV(DIM)                                                    \
  launch_dkv_simt<DIM>(grid, s, q, k, v, dout, lse, delta, dk, dv, ha,    \
                       Sq, Sk, H, KV, causal, window, cap, scale)
  switch (D) {
    case 32: FLASH_DKV(32); break;
    case 64: FLASH_DKV(64); break;
    case 80: FLASH_DKV(80); break;
    case 128: FLASH_DKV(128); break;
    case 256: FLASH_DKV(256); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_DKV
  return static_cast<int>(cudaGetLastError());
}
