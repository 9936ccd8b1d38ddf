// ssd_scan — the Mamba2 SSD chunk scan, forward (K8) and its transposed
// backward (K9), fp32, for sm_90a.
//
// Replaces the Pallas TPU kernels `_kernel` / `ssd_scan` (K8) and
// `_bwd_kernel` / `ssd_scan_bwd` (K9) in src/repro/kernels/ssd_scan.py.
// For x (R, S, H, P), dt (R, S, H), A (R, H) (each row its own A: each
// client its own A_log), B, C (R, S, G, N) and chunks of Q tokens, every
// (row, head) runs its chunks in order, carrying the (P, N) state h:
//
//   cum_t = Σ_{k≤t} dt_k·A                                (within a chunk)
//   y_t   = Σ_{s≤t} (C_t·B_s) e^{cum_t − cum_s} dt_s x_s + e^{cum_t} C_t·hᵀ
//   h    ← e^{cum_Q} h + Σ_s e^{cum_Q − cum_s} dt_s x_s ⊗ B_s
//
// K9 emits dx, ddt, du (the cotangent of u = dt·A), dB / dC per group and
// each (row, head, chunk)'s partial Σ_s du·dt in fp64, from du's fp64
// values; the wrapper sums the partials to dA in fp64. It reads the state each chunk entered with
// from the forward's `states` output (K8 rerun with states, flash style:
// no O(S·P) activations are kept). With dG = dy·xdtᵀ over P, L the masked
// decay, dCB = dG∘L, DL = dCB∘CB, w_s = e^{cum_Q − cum_s} and dh the
// cotangent of the state leaving the chunk (0 after the last):
//
//   dxdt_s = Σ_{t≥s} (L∘CB)[t,s] dy_t + w_s B_s·dhᵀ       dx = dxdt·dt
//   dB_s   = Σ_{t≥s} dCB[t,s] C_t + w_s xdt_s·dh
//   dC_t   = Σ_{s≤t} dCB[t,s] B_s + e^{cum_t} dy_t·h_in
//   T_s    = Σ_n B_s∘(xdt_s·dh)
//   dcum_t = Σ_s DL[t,s] − Σ_s DL[s,t] + e^{cum_t} Σ_n C_t∘(dy_t·h_in)
//            − w_t T_t
//   du_s   = Σ_{t≥s} dcum_t + e^{cum_Q} Σ dh∘h_in + Σ_t w_t T_t
//   dh (leaving the chunk before) = e^{cum_Q} dh + Σ_t (e^{cum_t} dy_t)ᵀ C_t
//
// Elasticity: a (R,) int32 head prefix h_active (null: every head). A
// head at or past its row's prefix issues no loads, gets zeros in every
// per-head output and adds nothing to its group's dB / dC.
//
// The `simt` variants (the first designs; K9's for the shapes its mma
// variant does not take). The TPU kernels carry the state in VMEM across
// a sequential grid axis over chunks; here one block owns one (row, head)
// and loops over the chunks itself, the state (K8) or its cotangent (K9)
// in shared memory (P·N·4 = 32 KB at P = 64, N = 128). A chunk's Q×Q
// decay-masked score block (256 KB at Q = 256) is tiled: query tiles of 64
// rows, and for each only the key tiles s ≤ t; exp is never evaluated on
// the upper triangle, where the reference's dense path overflows. K9's
// simt kernel runs two passes over the tile pairs — by query tile (dC and
// the row sums of DL) and by key tile (dx, dB and the column sums),
// recomputing the score tiles — then the state terms and the suffix sum
// to du, with scalar FMAs from shared memory on 4×4 register tiles (~215
// KB of shared memory: one block an SM), and writes dB / dC per head, which
// the wrapper sums over each group in torch.
//
// cum is accumulated in index order in fp64 and rounded to fp32 once: the
// plain versions (torch.cumsum of the fp32 products in float64) give the
// same bits whatever order their sum runs in. Every other sum runs in a
// fixed order; no atomics anywhere, so every variant is deterministic.
//
// What bounds it on the H100. Per live (row, head, chunk), with the causal
// triangle T = Q(Q+1)/2, and 2T·N per (row, group, chunk) for C·Bᵀ (one
// product per group): K8 2T·P + 4QPN; K9 2T(2N+2P) (dG and the intra-chunk
// products of dxdt, dB and dC) + 2QPN (dy·h_in, which also gives the
// inter-chunk term of dcum), and 6QPN in every chunk but one (xdt·dh and
// B·dhᵀ where dh ≠ 0, dh_y where it is used). At the training slice (16
// rows, 80 heads, prefixes 80/40/60/20, 2 chunks of 256, P = 64, N = 128):
// about 20 and 57.5 GFLOP against 0.22 and 0.39 GB of traffic — bound by
// the operations, in fp32 outside the tensor cores (67 TFLOP/s) and in
// 3×TF32 on them (three TF32 products at 495 TFLOP/s: K9 0.348 ms). (The
// simt K9 does 2T(3N+2P) + 10QPN per live (row, head, chunk), C·Bᵀ per
// head, and writes 335 MB of per-head dB / dC each: 87.5 GFLOP, 1.05 GB.)
//
// K8's `mma` variant (the main path's; kernels/ssd_scan.py::ssd_plan picks
// it from the shapes) does that work on the tensor cores in 3×TF32
// (csrc/mma_tf32.cuh: three TF32 products per fp32 product, each 8-deep
// step promoted into fp32 adds), in three launches:
//  1. `ssd_cum_kernel`: cum of every live (row, head, chunk), one thread
//     each, in index order in fp64 (as above), into a (R, H, S) buffer.
//  2. `ssd_cb_kernel`: C·Bᵀ once per (row, group, chunk), not once per
//     head (mamba2 has one group shared by its 80 heads), into a
//     (R, G, S/Q, Qp, Qp) buffer in device memory (8.4 MB at the training
//     slice: it stays in the 50 MB L2), 64 × 64 tiles on or below the
//     diagonal only, summed over N on the tensor cores. A group none of
//     whose heads is live issues no loads.
//  3. `ssd_fwd_mma_kernel`: a block per (row, head, slice of PT columns of
//     P) — the state's P rows are independent, so a slice is exact — 8
//     warps, chunks in order, the state slice (PT × N) in shared memory.
//     Per chunk: y_t = e^{cum_t}·(C_t·hᵀ) over N, then + Σ_{s≤t}
//     (L∘CB)[t, s]·dt_s x_s over the key tiles, and the state update
//     Σ_s (e^{cum_Q − cum_s} dt_s x_s)ᵀ B_s over the same key tiles: three
//     products on the tensor cores. x and B stream through a 3-stage
//     cp.async ring of 32-key tiles; L∘CB and C go from L2 straight into
//     the A fragments (each value feeds one warp), loaded one 8-deep step
//     ahead of their use so that L2's latency hides behind the previous
//     step's products. A warp owns query tiles
//     w and 15 − w, so that the causal triangle's work is even. The decay
//     is masked before the exponential (−∞ above the diagonal). PT = 32
//     keeps a block at ~86 KB of shared memory and its registers bounded
//     for two blocks per SM; where even that gives fewer blocks than SMs,
//     the plan halves PT (the P split, never a function of h_active).
//
// K9's `mma` variant (kernels/ssd_scan.py::ssd_bwd_plan): only dh has to
// run in chunk order; everything else in a chunk depends on that chunk's
// inputs, h_in and dh. Seven launches:
//  1, 2. `ssd_bwd_cum_kernel`, `ssd_bwd_cb_kernel`: K8's cum and C·Bᵀ (per
//     group), K9's own instances, so that a profile attributes them to K9.
//  3. `ssd_bwd_dh_kernel`: a block per (row, head, 32 columns of P), chunks
//     in reverse; dh ← e^{cum_Q} dh + Σ_t (e_t dy_t)ᵀ C_t over the chunk's
//     tokens on the tensor cores (ssd_fwd_mma_kernel's state update with
//     dy·e for x·dt·w and C for B), written per chunk as (R, S/Q − 1, H, P,
//     N), the mirror of K8's `states`, with Σ dh∘h_in in fp64 for du.
//  4, 5. `ssd_bwd_dc_kernel` (query tiles: dC, the row sums of DL, dy·h_in
//     and the inter term) and `ssd_bwd_dbx_kernel` (key tiles: dB, dxdt,
//     the column sums, the state terms, dx and Σ_p dxdt·x): a block per
//     (64-row tile, row, chunk, head slice of a group), 4 warps of 16
//     rows, the tiles with the most causal work first. A block loops over
//     the slice's live heads in head order and sums their dC (or dB) in
//     registers, so that it leaves once per group; with several slices a
//     group, each slice writes a partial. Per head, the other axis streams
//     in 32-row stages of P and N through a two-deep cp.async ring, 8 rows
//     an mma step: the step's dG tile, masked (−∞ above the diagonal before
//     the exponential), is the A fragment of the next product register for
//     register (k = 2t in slot t, 2t + 1 in slot t + 4); C·Bᵀ comes from L2
//     (8.4 MB at the training slice). h_in (query kernel) or dh (key
//     kernel; not in the last chunk) is then staged in the ring's space for
//     the products with the state. Every row stride is P + 4, N + 4 or
//     N + 8 floats, picked for bank-free fragment loads. Two blocks an SM
//     (~103 KB of shared memory each).
//  6. `ssd_bwd_sum_kernel`: the slices' partials of dB and dC summed in
//     slice order (no atomics; deterministic).
//  7. `ssd_bwd_du_kernel`: a warp per (row, head, chunk): dcum, the suffix
//     sums to du with the offset in fp64 (as the simt variant), ddt.
// Shapes the mma variants do not take (N not a multiple of 8 or above
// 128, Q above 256, operands not 16-byte aligned) run the `simt` variants.
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "mma_tf32.cuh"
#include "tile_counters.cuh"

namespace {

constexpr int kT = 64;            // rows of a query or key tile
constexpr int kThreads = 256;     // a 16 × 16 thread grid over a tile
constexpr int kMaxN = 128;        // d_state the per-thread arrays hold
constexpr int kNB = kMaxN / 16;   // state columns per thread
constexpr int kLdT = kT + 1;      // padded row of a (kT, kT) tile
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use

// Rows [row0, row0 + kT) of a chunk slice whose row i starts at
// src + i * stride, `width` values each, into dst[i * ld + k]; rows at or
// past Q are zero. Optional per-row scales (x · dt, x · dt · w).
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          long long stride, int row0, int Q,
                                          int width, const float* sc1,
                                          const float* sc2) {
  for (int e = threadIdx.x; e < kT * width; e += kThreads) {
    const int i = e / width, k = e - i * width;
    const int row = row0 + i;
    float v = 0.0f;
    if (row < Q) {
      v = src[(long long)row * stride + k];
      if (sc1 != nullptr) v = v * sc1[row];
      if (sc2 != nullptr) v = v * sc2[row];
    }
    dst[i * ld + k] = v;
  }
}

// cum[i] = Σ_{k≤i} dt[k]·a: each product rounded to fp32, summed in index
// order in fp64, rounded to fp32 once. One thread; the caller syncs.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a,
                                             float* cum, int Q) {
  if (threadIdx.x == 0) {
    double acc = 0.0;
    for (int i = 0; i < Q; ++i) {
      acc += (double)__fmul_rn(dts[i], a);
      cum[i] = (float)acc;
    }
  }
}

// Sum over the 16 lanes of a half warp (the tx axis of the thread grid).
__device__ __forceinline__ float half_warp_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

// e^{cum_t − cum_s} for s ≤ t < Q, else 0 — exp only below the diagonal.
__device__ __forceinline__ float decay(const float* cum, int t, int s,
                                       int Q) {
  return (s <= t && t < Q) ? expf(cum[t] - cum[s]) : 0.0f;
}

// (Cs rows ty+16i) · (Bs rows tx+16j) over n < N: a 4×4 score tile.
__device__ __forceinline__ void score_tile(const float* As, const float* Bs,
                                           int ld, int K, int tx, int ty,
                                           float (&sc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * ld + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * ld + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
  }
}

struct Geo {
  int S, H, G, N, Q;
  long long xrow, brow;   // elements between two positions: x / y, B / C
};

__device__ __forceinline__ Geo geo(int S, int H, int G, int N, int Q,
                                   int P) {
  Geo g{S, H, G, N, Q, (long long)H * P, (long long)G * N};
  return g;
}

// ---------------------------------------------------------------------------
// K8: the forward scan
// ---------------------------------------------------------------------------
template <int P>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ B,
               const float* __restrict__ C, const int* __restrict__ ha,
               float* __restrict__ y, float* __restrict__ states, int S,
               int H, int G, int N, int Q) {
  constexpr int PJ = P / 16;        // p columns per thread
  constexpr int kLdX = P + 1;
  extern __shared__ float smem[];
  const Geo q = geo(S, H, G, N, Q, P);
  const int ldn = N + 1;
  const int r = blockIdx.x / H, h = blockIdx.x - r * H;
  const int grp = h / (H / G);
  const int nc = S / Q;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long pn = (long long)P * N;
  const float* xb = x + (long long)r * S * q.xrow + (long long)h * P;
  float* yb = y + (long long)r * S * q.xrow + (long long)h * P;
  const float* dtb = dt + (long long)r * S * H + h;
  const float* Bb = B + (long long)r * S * q.brow + (long long)grp * N;
  const float* Cb = C + (long long)r * S * q.brow + (long long)grp * N;
  float* stb = states == nullptr ? nullptr
                                 : states + ((long long)r * nc * H + h) * pn;
  const long long st_c = (long long)H * pn;   // between two chunks' states

  if (ha != nullptr && h >= ha[r]) {          // past the prefix: zeros
    for (long long e = tid; e < (long long)S * P; e += kThreads)
      yb[(e / P) * q.xrow + e % P] = 0.0f;
    if (stb != nullptr)
      for (int c = 0; c < nc; ++c)
        for (long long e = tid; e < pn; e += kThreads) stb[c * st_c + e] = 0.0f;
    return;
  }
  float* Hs = smem;                  // [P][ldn] the state h[p][n]
  float* Cs = Hs + P * ldn;          // [kT][ldn] C rows of the query tile
  float* Bs = Cs + kT * ldn;         // [kT][ldn] B rows of the key tile
  float* Xs = Bs + kT * ldn;         // [kT][kLdX] x·dt rows of the key tile
  float* Ps = Xs + kT * kLdX;        // [kT][kLdT] masked score tile
  float* cum = Ps + kT * kLdT;       // [Q]
  float* dts = cum + Q;              // [Q]
  float* wend = dts + Q;             // [Q] e^{cum_Q − cum_s}
  for (int e = tid; e < P * ldn; e += kThreads) Hs[e] = 0.0f;
  const float a = A[(long long)r * H + h];
  TC_DECL;  // a chunk a tile; each 64-row tile load_rows copies a block

  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    TC_TILES(1);
    const float* xc = xb + (long long)c0 * q.xrow;
    const float* Bc = Bb + (long long)c0 * q.brow;
    const float* Cc = Cb + (long long)c0 * q.brow;
    for (int i = tid; i < Q; i += kThreads)
      dts[i] = dtb[(long long)(c0 + i) * H];
    __syncthreads();
    chunk_cumsum(dts, a, cum, Q);
    __syncthreads();
    for (int i = tid; i < Q; i += kThreads) wend[i] = expf(cum[Q - 1] - cum[i]);
    if (stb != nullptr) {            // the state this chunk enters with
      float* st = stb + c * st_c;
      for (long long e = tid; e < pn; e += kThreads)
        st[e] = Hs[(e / N) * ldn + e % N];
    }
    for (int q0 = 0; q0 < Q; q0 += kT) {
      load_rows(Cs, ldn, Cc, q.brow, q0, Q, N, nullptr, nullptr);
      TC_DMA(1);
      float acc[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.0f;
      for (int k0 = 0; k0 <= q0; k0 += kT) {
        load_rows(Bs, ldn, Bc, q.brow, k0, Q, N, nullptr, nullptr);
        load_rows(Xs, kLdX, xc, q.xrow, k0, Q, P, dts, nullptr);
        TC_DMA(2);
        __syncthreads();
        float sc[4][4];
        score_tile(Cs, Bs, ldn, N, tx, ty, sc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            Ps[(ty + 16 * i) * kLdT + tx + 16 * j] =
                sc[i][j] * decay(cum, q0 + ty + 16 * i, k0 + tx + 16 * j, Q);
        __syncthreads();
        const int rows = min(kT, Q - k0);
        for (int s = 0; s < rows; ++s) {
          float pa[4], xv[PJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * kLdT + s];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xv[j] = Xs[s * kLdX + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j)
              acc[i][j] = fmaf(pa[i], xv[j], acc[i][j]);
        }
        __syncthreads();
      }
      // the state the chunk entered with: e^{cum_t} · C_t·hᵀ
      float in[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) in[i][j] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float ca[4], hv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) ca[i] = Cs[(ty + 16 * i) * ldn + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) hv[j] = Hs[(tx + 16 * j) * ldn + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) in[i][j] = fmaf(ca[i], hv[j], in[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = q0 + ty + 16 * i;
        if (t >= Q) continue;
        const float e = expf(cum[t]);
#pragma unroll
        for (int j = 0; j < PJ; ++j)
          yb[(long long)(c0 + t) * q.xrow + tx + 16 * j] =
              __fadd_rn(acc[i][j], __fmul_rn(e, in[i][j]));
      }
      __syncthreads();
    }
    // h ← e^{cum_Q} h + Σ_s (x_s·dt_s·w_s) ⊗ B_s; thread: p = ty+16i,
    // n = tx+16j
    float hacc[PJ][kNB];
#pragma unroll
    for (int i = 0; i < PJ; ++i)
#pragma unroll
      for (int j = 0; j < kNB; ++j) hacc[i][j] = 0.0f;
    for (int k0 = 0; k0 < Q; k0 += kT) {
      load_rows(Bs, ldn, Bc, q.brow, k0, Q, N, nullptr, nullptr);
      load_rows(Xs, kLdX, xc, q.xrow, k0, Q, P, dts, wend);
      TC_DMA(2);
      __syncthreads();
      const int rows = min(kT, Q - k0);
      for (int s = 0; s < rows; ++s) {
        float xv[PJ], bv[kNB];
#pragma unroll
        for (int i = 0; i < PJ; ++i) xv[i] = Xs[s * kLdX + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kNB; ++j)
          bv[j] = (tx + 16 * j < N) ? Bs[s * ldn + tx + 16 * j] : 0.0f;
#pragma unroll
        for (int i = 0; i < PJ; ++i)
#pragma unroll
          for (int j = 0; j < kNB; ++j)
            hacc[i][j] = fmaf(xv[i], bv[j], hacc[i][j]);
      }
      __syncthreads();
    }
    const float E = expf(cum[Q - 1]);
#pragma unroll
    for (int i = 0; i < PJ; ++i)
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const int n = tx + 16 * j;
        if (n < N) {
          float& hv = Hs[(ty + 16 * i) * ldn + n];
          hv = __fadd_rn(__fmul_rn(hv, E), hacc[i][j]);
        }
      }
    __syncthreads();
  }
  TC_FLUSH(tid == 0);
}

// ---------------------------------------------------------------------------
// K8, mma variant: cum, C·Bᵀ per group, then the scan on 3×TF32 tensor cores
// ---------------------------------------------------------------------------
constexpr int kCumHeads = 32;   // heads (threads) of a cum block
constexpr int kCbT = 64;        // rows and columns of a C·Bᵀ tile
constexpr int kCbThreads = 128; // 4 warps of 32 × 32
constexpr int kKT = 32;         // keys of a ring stage
constexpr int kStages = 3;      // depth of the cp.async ring
constexpr int kMmaThreads = 256;
constexpr int kQMax = 256;      // 16 query tiles of 16: two per warp

// Whether head h of row r is live.
__device__ __forceinline__ bool head_live(const int* ha, int r, int h) {
  return ha == nullptr || h < ha[r];
}

// cum[r, h, c·Q + t] = Σ_{k≤t} dt·A for every live head: a block per (32
// heads, chunk, row), a thread per head summing its chunk in index order
// in fp64 (as chunk_cumsum), written out through shared memory (`tile`,
// [Q][kCumHeads + 1]) so that each head's Q values leave as one contiguous
// run. K8 and K9 each launch their own instance (ssd_cum_kernel,
// ssd_bwd_cum_kernel), so that a profile attributes the time to each.
__device__ __forceinline__ void cum_body(const float* __restrict__ dt,
                                         const float* __restrict__ A,
                                         const int* __restrict__ ha,
                                         float* __restrict__ cum, int S,
                                         int H, int Q, float* tile) {
  const int lane = threadIdx.x;
  const int h0 = blockIdx.x * kCumHeads, c0 = blockIdx.y * Q;
  const int r = blockIdx.z;
  const int h = h0 + lane;
  if (h < H && head_live(ha, r, h)) {
    const float a = A[(long long)r * H + h];
    const float* d = dt + ((long long)r * S + c0) * H + h;
    double acc = 0.0;
    for (int t = 0; t < Q; ++t) {
      acc += (double)__fmul_rn(d[(long long)t * H], a);
      tile[t * (kCumHeads + 1) + lane] = (float)acc;
    }
  }
  __syncwarp();
  for (int j = 0; j < kCumHeads; ++j) {
    const int hj = h0 + j;
    if (hj >= H || !head_live(ha, r, hj)) continue;
    float* out = cum + ((long long)r * H + hj) * S + c0;
    for (int t = lane; t < Q; t += kCumHeads)
      out[t] = tile[t * (kCumHeads + 1) + j];
  }
}

__global__ void __launch_bounds__(kCumHeads)
ssd_cum_kernel(const float* __restrict__ dt, const float* __restrict__ A,
               const int* __restrict__ ha, float* __restrict__ cum, int S,
               int H, int Q) {
  extern __shared__ float tile[];
  cum_body(dt, A, ha, cum, S, H, Q, tile);
}

// cb[r, g, c, t, s] = C_t·B_s over N for one 64 × 64 tile on or below the
// diagonal of chunk c (grid x: the tiles (ti, si), si ≤ ti; grid y: (r, g,
// c)). Both operands are K-contiguous: native k order, rows padded to
// N + 4 (words 4g + t of a fragment load: distinct banks). K8 and K9 each
// launch their own instance (ssd_cb_kernel, ssd_bwd_cb_kernel).
__device__ __forceinline__ void cb_body(const float* __restrict__ B,
                                        const float* __restrict__ C,
                                        const int* __restrict__ ha,
                                        float* __restrict__ cb, int S, int H,
                                        int G, int N, int Q, int Qp,
                                        float* smem) {
  const int ld = N + 4;
  float* Cs = smem;            // [kCbT][ld] C rows t0 ..
  float* Bs = smem + kCbT * ld; // [kCbT][ld] B rows s0 ..
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= (int)blockIdx.x) ++ti;
  const int si = blockIdx.x - ti * (ti + 1) / 2;
  const int nc = S / Q;
  const int z = blockIdx.y;                 // (r·G + grp)·nc + c
  const int c = z % nc, grp = (z / nc) % G, r = z / (nc * G);
  if (!head_live(ha, r, grp * (H / G))) return;  // no live head reads it
  const int t0 = ti * kCbT, s0 = si * kCbT, tid = threadIdx.x;
  const long long row = (long long)G * N;  // between two positions
  const float* Cc = C + ((long long)r * S + (long long)c * Q) * row +
                    (long long)grp * N;
  const float* Bc = B + ((long long)r * S + (long long)c * Q) * row +
                    (long long)grp * N;
  for (int e = tid; e < kCbT * (N / 4); e += kCbThreads) {
    const int i = e / (N / 4), k = (e % (N / 4)) * 4;
    const bool tq = t0 + i < Q, sq = s0 + i < Q;
    tf32x3::cp_async16(Cs + i * ld + k,
                       tq ? Cc + (long long)(t0 + i) * row + k : C,
                       tq ? 16 : 0);
    tf32x3::cp_async16(Bs + i * ld + k,
                       sq ? Bc + (long long)(s0 + i) * row + k : B,
                       sq ? 16 : 0);
  }
  tf32x3::cp_async_commit();
  tf32x3::cp_async_wait<0>();
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
  for (int k0 = 0; k0 < N; k0 += 8) {
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* b = Bs + (wn + j * 8 + g) * ld + k0 + t;
      tf32x3::split(b[0], bh[j][0], bl[j][0]);
      tf32x3::split(b[4], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* a = Cs + (wm + i * 16 + g) * ld + k0 + t;
      uint32_t ah[4], al[4];
      tf32x3::split(a[0], ah[0], al[0]);
      tf32x3::split(a[8 * ld], ah[1], al[1]);
      tf32x3::split(a[4], ah[2], al[2]);
      tf32x3::split(a[8 * ld + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tf32x3::mma3_add(acc[i][j], ah, al, bh[j], bl[j]);
    }
  }
  float* out = cb + (long long)z * Qp * Qp;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* o = out + (long long)(t0 + wm + i * 16 + g + 8 * h) * Qp + s0 +
                 wn + 2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(o + j * 8) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
}

__global__ void __launch_bounds__(kCbThreads)
ssd_cb_kernel(const float* __restrict__ B, const float* __restrict__ C,
              const int* __restrict__ ha, float* __restrict__ cb, int S,
              int H, int G, int N, int Q, int Qp) {
  extern __shared__ __align__(16) float smem[];
  cb_body(B, C, ha, cb, S, H, G, N, Q, Qp, smem);
}

// Shared memory of `ssd_fwd_mma_kernel<PT>`: the state slice, the ring and
// four chunk vectors.
__host__ __device__ constexpr size_t mma_fwd_floats(int PT, int N, int Qr) {
  return (size_t)PT * (N + 8) + (size_t)kStages * kKT * (PT + 4 + N + 4) +
         4 * (size_t)Qr;
}

// The scan of one (row, head, PT columns of P): see the header. Warp w
// owns query tiles w and 15 − w (slot 0 and 1) for y, and the state tile
// rows [wp, wp + 16) × columns [wn, wn + PT) for the update.
template <int PT>
__global__ void __launch_bounds__(kMmaThreads, 2)
ssd_fwd_mma_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ B, const float* __restrict__ C,
                   const float* __restrict__ cb,
                   const float* __restrict__ cum, const int* __restrict__ ha,
                   float* __restrict__ y, float* __restrict__ states, int S,
                   int H, int P, int G, int N, int Q, int Qp) {
  constexpr int NT = PT / 8;          // n8 tiles of y's and the update's
  constexpr int WARPS_P = PT / 16;    // state: warps along P ...
  constexpr int WARPS_N = 8 / WARPS_P;  // ... and along N (8·NT columns)
  constexpr int LDX = PT + 4;         // rows of a ring x tile: 8t + g
  extern __shared__ __align__(16) float smem[];
  const int ldh = N + 8, ldb = N + 4;
  const int Qr = (Q + kKT - 1) / kKT * kKT;
  float* hs = smem;                          // [PT][ldh] the state slice
  float* ring = hs + PT * ldh;               // kStages × (x tile, B tile)
  const int stage_floats = kKT * (LDX + ldb);
  float* cumv = ring + kStages * stage_floats;  // [Qr] cum_t
  float* dts = cumv + Qr;                    // [Qr] dt_t
  float* wend = dts + Qr;                    // [Qr] e^{cum_Q − cum_s}
  float* ev = wend + Qr;                     // [Qr] e^{cum_t}

  const int slices = P / PT;
  const int ps = blockIdx.x % slices;
  const int h = (blockIdx.x / slices) % H, r = blockIdx.x / (slices * H);
  const int p0 = ps * PT, grp = h / (H / G), nc = S / Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long xrow = (long long)H * P, brow = (long long)G * N;
  const long long pn = (long long)P * N;
  const float* xb = x + (long long)r * S * xrow + (long long)h * P + p0;
  float* yb = y + (long long)r * S * xrow + (long long)h * P + p0;
  const float* dtb = dt + (long long)r * S * H + h;
  const float* Bb = B + (long long)r * S * brow + (long long)grp * N;
  const float* Cb = C + (long long)r * S * brow + (long long)grp * N;
  const float* cumb = cum + ((long long)r * H + h) * S;
  float* stb = states == nullptr
                   ? nullptr
                   : states + ((long long)r * nc * H + h) * pn + (long long)p0 * N;
  const long long st_c = (long long)H * pn;   // between two chunks' states

  if (!head_live(ha, r, h)) {                 // past the prefix: zeros
    for (long long e = tid; e < (long long)S * PT; e += kMmaThreads)
      yb[(e / PT) * xrow + e % PT] = 0.0f;
    if (stb != nullptr)
      for (int c = 0; c < nc; ++c)
        for (long long e = tid; e < (long long)PT * N; e += kMmaThreads)
          stb[c * st_c + e] = 0.0f;
    return;
  }
  for (int e = tid; e < PT * ldh; e += kMmaThreads) hs[e] = 0.0f;
  __syncthreads();

  // warp tiles: y's query tiles (slot 1 only when Q has 16 of them) and the
  // state update's rows / columns
  const int n_qt = (Q + 15) / 16;
  const int qt[2] = {warp, 15 - warp};
  const bool has_qt[2] = {warp < n_qt, 15 - warp < n_qt && 15 - warp > 7};
  const int wp = (warp / WARPS_N) * 16, wn = (warp % WARPS_N) * 8 * NT;
  const int n_kt = Qr / kKT;
  TC_DECL;  // a chunk a tile; a stage's x and B tiles 2 blocks

  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    const float* xc = xb + (long long)c0 * xrow;
    const float* Bc = Bb + (long long)c0 * brow;
    const float* Cc = Cb + (long long)c0 * brow;
    TC_TILES(1);
    // one ring stage: keys [kt·32, kt·32 + 32) of x (PT columns) and B
    auto load_stage = [&](int kt) {
      float* xs = ring + (kt % kStages) * stage_floats;
      float* bs = xs + kKT * LDX;
      TC_DMA(2);
      for (int e = tid; e < kKT * (PT / 4); e += kMmaThreads) {
        const int i = e / (PT / 4), k = (e % (PT / 4)) * 4;
        const int s = kt * kKT + i;
        tf32x3::cp_async16(xs + i * LDX + k,
                           s < Q ? xc + (long long)s * xrow + k : x,
                           s < Q ? 16 : 0);
      }
      for (int e = tid; e < kKT * (N / 4); e += kMmaThreads) {
        const int i = e / (N / 4), k = (e % (N / 4)) * 4;
        const int s = kt * kKT + i;
        tf32x3::cp_async16(bs + i * ldb + k,
                           s < Q ? Bc + (long long)s * brow + k : B,
                           s < Q ? 16 : 0);
      }
    };
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < n_kt) load_stage(k);
      tf32x3::cp_async_commit();
    }
    for (int i = tid; i < Qr; i += kMmaThreads) {
      cumv[i] = i < Q ? cumb[c0 + i] : 0.0f;
      dts[i] = i < Q ? dtb[(long long)(c0 + i) * H] : 0.0f;
    }
    if (stb != nullptr) {            // the state this chunk enters with
      float* st = stb + c * st_c;
      for (int e = tid; e < PT * N; e += kMmaThreads)
        st[e] = hs[(e / N) * ldh + e % N];
    }
    __syncthreads();
    const float cum_end = cumv[Q - 1];
    for (int i = tid; i < Qr; i += kMmaThreads) {
      ev[i] = i < Q ? expf(cumv[i]) : 0.0f;
      wend[i] = i < Q ? expf(cum_end - cumv[i]) : 0.0f;
    }

    // y_t = e^{cum_t} · C_t·hᵀ: A = C rows (from L2), B = the state slice
    float acc[2][NT][4];
#pragma unroll
    for (int sl = 0; sl < 2; ++sl)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[sl][j][q] = 0.0f;
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      if (!has_qt[sl]) continue;
      const int ta = qt[sl] * 16 + g, tb = ta + 8;
      const float* ca = Cc + (long long)ta * brow + 2 * t;
      const float* cbr = Cc + (long long)tb * brow + 2 * t;
      // the C values of the next 8-deep step are in flight during this one
      const float2 zero2 = make_float2(0.0f, 0.0f);
      float2 na = ta < Q ? *reinterpret_cast<const float2*>(ca) : zero2;
      float2 nb = tb < Q ? *reinterpret_cast<const float2*>(cbr) : zero2;
      for (int n0 = 0; n0 < N; n0 += 8) {
        const float2 va = na, vb = nb;
        if (n0 + 8 < N) {
          na = ta < Q ? *reinterpret_cast<const float2*>(ca + n0 + 8) : zero2;
          nb = tb < Q ? *reinterpret_cast<const float2*>(cbr + n0 + 8)
                      : zero2;
        }
        uint32_t ah[4], al[4];
        tf32x3::split(va.x, ah[0], al[0]);
        tf32x3::split(vb.x, ah[1], al[1]);
        tf32x3::split(va.y, ah[2], al[2]);
        tf32x3::split(vb.y, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 hv = *reinterpret_cast<const float2*>(
              hs + (j * 8 + g) * ldh + n0 + 2 * t);
          uint32_t bh[2], bl[2];
          tf32x3::split(hv.x, bh[0], bl[0]);
          tf32x3::split(hv.y, bh[1], bl[1]);
          tf32x3::mma3_add(acc[sl][j], ah, al, bh, bl);
        }
      }
    }
    __syncthreads();                 // ev is in place
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      if (!has_qt[sl]) continue;
      const int ta = qt[sl] * 16 + g;
      const float ea = ta < Q ? ev[ta] : 0.0f;
      const float eb = ta + 8 < Q ? ev[ta + 8] : 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[sl][j][0] *= ea;
        acc[sl][j][1] *= ea;
        acc[sl][j][2] *= eb;
        acc[sl][j][3] *= eb;
      }
    }

    // the key tiles: y += (L∘CB)·(dt x), and the state update's sum
    float hacc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) hacc[j][q] = 0.0f;
    const float* cbz =
        cb + ((long long)(r * G + grp) * nc + c) * Qp * Qp;
    // L∘CB's A fragments read C·Bᵀ from L2: rows ta, tb of each query tile
    // at keys sa, sb of the 8-deep step s0 (zero where the tile has none)
    auto cb_load = [&](int s0, float2 (&v)[2][2]) {
#pragma unroll
      for (int sl = 0; sl < 2; ++sl)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int tt = qt[sl] * 16 + g + 8 * u;
          v[sl][u] = has_qt[sl] && s0 <= qt[sl] * 16 + 15 && tt < Q
                         ? *reinterpret_cast<const float2*>(
                               cbz + (long long)tt * Qp + s0 + 2 * t)
                         : make_float2(0.0f, 0.0f);
        }
    };
    float2 cbn[2][2];                  // the next step's values, in flight
    cb_load(0, cbn);
    for (int kt = 0; kt < n_kt; ++kt) {
      tf32x3::cp_async_wait<kStages - 2>();  // stage kt has landed
      __syncthreads();  // ... for every thread; stage kt - 1 is free again
      if (kt + kStages - 1 < n_kt) load_stage(kt + kStages - 1);
      tf32x3::cp_async_commit();
      const float* xs = ring + (kt % kStages) * stage_floats;
      const float* bs = xs + kKT * LDX;
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 8) {
        const int s0 = kt * kKT + kk;
        const int sa = s0 + 2 * t, sb = sa + 1;     // this thread's keys
        const float da = dts[sa], db = dts[sb];
        float2 cbv[2][2];
#pragma unroll
        for (int sl = 0; sl < 2; ++sl)
#pragma unroll
          for (int u = 0; u < 2; ++u) cbv[sl][u] = cbn[sl][u];
        cb_load(s0 + 8, cbn);
        // y: B = dt·x rows sa, sb (shared by both query tiles)
        if ((has_qt[0] && s0 <= qt[0] * 16 + 15) ||
            (has_qt[1] && s0 <= qt[1] * 16 + 15)) {
          uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int p = j * 8 + g;
            tf32x3::split(__fmul_rn(xs[(kk + 2 * t) * LDX + p], da),
                          bh[j][0], bl[j][0]);
            tf32x3::split(__fmul_rn(xs[(kk + 2 * t + 1) * LDX + p], db),
                          bh[j][1], bl[j][1]);
          }
          const float csa = cumv[sa], csb = cumv[sb];
#pragma unroll
          for (int sl = 0; sl < 2; ++sl) {
            if (!has_qt[sl] || s0 > qt[sl] * 16 + 15) continue;
            const int ta = qt[sl] * 16 + g, tb = ta + 8;
            float a[4];                    // (ta, sa) (tb, sa) (ta, sb) (tb, sb)
            const int ts[2] = {ta, tb};
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int tt = ts[u];
              const float2 v = cbv[sl][u];
              const float ct = tt < Q ? cumv[tt] : 0.0f;
              // masked before the exponential: −∞ above the diagonal
              const float la = expf(sa <= tt ? ct - csa : -INFINITY);
              const float lb = expf(sb <= tt ? ct - csb : -INFINITY);
              a[u] = (sa <= tt && tt < Q) ? __fmul_rn(v.x, la) : 0.0f;
              a[u + 2] = (sb <= tt && tt < Q) ? __fmul_rn(v.y, lb) : 0.0f;
            }
            uint32_t ah[4], al[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) tf32x3::split(a[q], ah[q], al[q]);
#pragma unroll
            for (int j = 0; j < NT; ++j)
              tf32x3::mma3_add(acc[sl][j], ah, al, bh[j], bl[j]);
          }
        }
        // the state update: A = (w·dt·x)ᵀ rows p, B = B rows sa, sb
        {
          const float wa = wend[sa], wb = wend[sb];
          const float* xa = xs + (kk + 2 * t) * LDX + wp + g;
          const float* xbk = xs + (kk + 2 * t + 1) * LDX + wp + g;
          uint32_t ah[4], al[4];
          tf32x3::split(__fmul_rn(__fmul_rn(xa[0], da), wa), ah[0], al[0]);
          tf32x3::split(__fmul_rn(__fmul_rn(xa[8], da), wa), ah[1], al[1]);
          tf32x3::split(__fmul_rn(__fmul_rn(xbk[0], db), wb), ah[2], al[2]);
          tf32x3::split(__fmul_rn(__fmul_rn(xbk[8], db), wb), ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int n = wn + j * 8 + g;
            if (wn + j * 8 >= N) continue;
            uint32_t bh[2], bl[2];
            tf32x3::split(bs[(kk + 2 * t) * ldb + n], bh[0], bl[0]);
            tf32x3::split(bs[(kk + 2 * t + 1) * ldb + n], bh[1], bl[1]);
            tf32x3::mma3_add(hacc[j], ah, al, bh, bl);
          }
        }
      }
    }
    tf32x3::cp_async_wait<0>();

    // y rows t < Q of the warp's query tiles
    float* yc = yb + (long long)c0 * xrow;
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      if (!has_qt[sl]) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int tt = qt[sl] * 16 + g + 8 * hh;
        if (tt >= Q) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          *reinterpret_cast<float2*>(yc + (long long)tt * xrow + j * 8 +
                                     2 * t) =
              make_float2(acc[sl][j][2 * hh], acc[sl][j][2 * hh + 1]);
      }
    }
    __syncthreads();                 // every warp is done reading hs
    // h ← e^{cum_Q} h + Σ_s (w·dt·x)_s ⊗ B_s
    const float E = expf(cum_end);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = wn + j * 8 + 2 * t;
      if (wn + j * 8 >= N) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* hv = hs + (wp + g + 8 * hh) * ldh + n;
        hv[0] = __fadd_rn(__fmul_rn(hv[0], E), hacc[j][2 * hh]);
        hv[1] = __fadd_rn(__fmul_rn(hv[1], E), hacc[j][2 * hh + 1]);
      }
    }
    __syncthreads();
  }
  TC_FLUSH(tid == 0);
}

// ---------------------------------------------------------------------------
// K9: the transposed scan
// ---------------------------------------------------------------------------
template <int P>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ B,
               const float* __restrict__ C, const float* __restrict__ states,
               const float* __restrict__ dy, const int* __restrict__ ha,
               float* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ du, float* __restrict__ dB,
               float* __restrict__ dC, double* __restrict__ dap, int S,
               int H, int G, int N, int Q) {
  constexpr int PJ = P / 16;
  constexpr int kLdX = P + 1;
  extern __shared__ float smem[];
  const Geo q = geo(S, H, G, N, Q, P);
  const int ldn = N + 1;
  const int r = blockIdx.x / H, h = blockIdx.x - r * H;
  const int grp = h / (H / G);
  const int nc = S / Q;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long pn = (long long)P * N;
  const long long hn = (long long)H * N;      // between two positions: dB, dC
  const long long xoff = (long long)r * S * q.xrow + (long long)h * P;
  const float* xb = x + xoff;
  const float* dyb = dy + xoff;
  float* dxb = dx + xoff;
  const long long toff = (long long)r * S * H + h;
  const float* dtb = dt + toff;
  float* ddtb = ddt + toff;
  float* dub = du + toff;
  const float* Bb = B + (long long)r * S * q.brow + (long long)grp * N;
  const float* Cb = C + (long long)r * S * q.brow + (long long)grp * N;
  const long long hoff = (long long)r * S * hn + (long long)h * N;
  float* dBb = dB + hoff;
  float* dCb = dC + hoff;
  const float* stb = states + ((long long)r * nc * H + h) * pn;
  const long long st_c = (long long)H * pn;
  double* dapb = dap + ((long long)r * H + h) * nc;

  if (ha != nullptr && h >= ha[r]) {          // past the prefix: zeros
    for (long long e = tid; e < (long long)S * P; e += kThreads)
      dxb[(e / P) * q.xrow + e % P] = 0.0f;
    for (long long e = tid; e < (long long)S * N; e += kThreads) {
      dBb[(e / N) * hn + e % N] = 0.0f;
      dCb[(e / N) * hn + e % N] = 0.0f;
    }
    for (int s = tid; s < S; s += kThreads) {
      ddtb[(long long)s * H] = 0.0f;
      dub[(long long)s * H] = 0.0f;
    }
    for (int c = tid; c < nc; c += kThreads) dapb[c] = 0.0;
    return;
  }
  double* red = reinterpret_cast<double*>(smem);  // [kThreads]
  double* r64 = red + kThreads;      // [Q] the row sums of DL in fp64 (dA)
  double* c64 = r64 + Q;             // [Q] its column sums in fp64
  float* Hin = smem + 2 * kThreads + 4 * Q;  // [P][ldn] state entering
  float* dH = Hin + P * ldn;         // [P][ldn] cotangent of the state out
  float* Cs = dH + P * ldn;          // [kT][ldn] C rows of a query tile
  float* Bs = Cs + kT * ldn;         // [kT][ldn] B rows of a key tile
  float* Ds = Bs + kT * ldn;         // [kT][kLdX] dy rows of a query tile
  float* Xs = Ds + kT * kLdX;        // [kT][kLdX] x·dt rows of a key tile
  float* T1 = Xs + kT * kLdX;        // [kT][kLdT]
  float* T2 = T1 + kT * kLdT;        // [kT][kLdT]
  float* cum = T2 + kT * kLdT;       // [Q] each of the chunk vectors below
  float* dts = cum + Q;
  float* wend = dts + Q;             // e^{cum_Q − cum_s}
  float* ev = wend + Q;              // e^{cum_t}
  float* rsum = ev + Q;              // Σ_s (dG∘L∘CB)[t, s], then dcum
  float* csum = rsum + Q;            // Σ_t (dG∘L∘CB)[t, s], then du
  float* inter = csum + Q;           // e_t Σ_p dy_t·(C_t·h_inᵀ)
  float* tw = inter + Q;             // T_s · w_s
  float* dxx = tw + Q;               // Σ_p dxdt·x
  for (int e = tid; e < P * ldn; e += kThreads) dH[e] = 0.0f;
  const float a = A[(long long)r * H + h];
  TC_DECL;  // a chunk a tile; each 64-row tile load_rows copies a block

  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * Q;
    TC_TILES(1);
    const float* xc = xb + (long long)c0 * q.xrow;
    const float* dyc = dyb + (long long)c0 * q.xrow;
    const float* Bc = Bb + (long long)c0 * q.brow;
    const float* Cc = Cb + (long long)c0 * q.brow;
    for (int i = tid; i < Q; i += kThreads) {
      dts[i] = dtb[(long long)(c0 + i) * H];
      rsum[i] = 0.0f;
      csum[i] = 0.0f;
      r64[i] = 0.0;
      c64[i] = 0.0;
    }
    for (long long e = tid; e < pn; e += kThreads)
      Hin[(e / N) * ldn + e % N] = stb[c * st_c + e];
    __syncthreads();
    chunk_cumsum(dts, a, cum, Q);
    __syncthreads();
    for (int i = tid; i < Q; i += kThreads) {
      wend[i] = expf(cum[Q - 1] - cum[i]);
      ev[i] = expf(cum[i]);
    }
    __syncthreads();

    // pass A, by query tile: dC_t = Σ_s dCB[t,s] B_s + e_t dy_t·h_in, and
    // the row sums of DL = dCB∘CB (dCB = dG∘L, dG[t,s] = dy_t·xdt_s)
    for (int q0 = 0; q0 < Q; q0 += kT) {
      load_rows(Cs, ldn, Cc, q.brow, q0, Q, N, nullptr, nullptr);
      load_rows(Ds, kLdX, dyc, q.xrow, q0, Q, P, nullptr, nullptr);
      TC_DMA(2);
      float dcv[4][kNB];                 // t = ty+16i, n = tx+16j
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNB; ++j) dcv[i][j] = 0.0f;
      for (int k0 = 0; k0 <= q0; k0 += kT) {
        load_rows(Bs, ldn, Bc, q.brow, k0, Q, N, nullptr, nullptr);
        load_rows(Xs, kLdX, xc, q.xrow, k0, Q, P, dts, nullptr);
        TC_DMA(2);
        __syncthreads();
        float cb[4][4], dg[4][4];
        score_tile(Cs, Bs, ldn, N, tx, ty, cb);
        score_tile(Ds, Xs, kLdX, P, tx, ty, dg);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float dcb =
                dg[i][j] * decay(cum, q0 + ty + 16 * i, k0 + tx + 16 * j, Q);
            T1[(ty + 16 * i) * kLdT + tx + 16 * j] = dcb;
            T2[(ty + 16 * i) * kLdT + tx + 16 * j] = dcb * cb[i][j];
          }
        __syncthreads();
        const int rows = min(kT, Q - k0);
        for (int s = 0; s < rows; ++s) {
          float tv[4], bv[kNB];
#pragma unroll
          for (int i = 0; i < 4; ++i) tv[i] = T1[(ty + 16 * i) * kLdT + s];
#pragma unroll
          for (int j = 0; j < kNB; ++j)
            bv[j] = (tx + 16 * j < N) ? Bs[s * ldn + tx + 16 * j] : 0.0f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < kNB; ++j)
              dcv[i][j] = fmaf(tv[i], bv[j], dcv[i][j]);
        }
        if (tid < kT && q0 + tid < Q) {
          float acc = 0.0f;
          double acc64 = 0.0;
          for (int s = 0; s < rows; ++s) {
            acc += T2[tid * kLdT + s];
            acc64 += (double)T2[tid * kLdT + s];
          }
          rsum[q0 + tid] += acc;
          r64[q0 + tid] += acc64;
        }
        __syncthreads();
      }
      // dy_t·h_in (the inter-chunk read's cotangent), for dC and dcum
      float dyh[4][kNB];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNB; ++j) dyh[i][j] = 0.0f;
      for (int p = 0; p < P; ++p) {
        float dv[4], hv[kNB];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = Ds[(ty + 16 * i) * kLdX + p];
#pragma unroll
        for (int j = 0; j < kNB; ++j)
          hv[j] = (tx + 16 * j < N) ? Hin[p * ldn + tx + 16 * j] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kNB; ++j)
            dyh[i][j] = fmaf(dv[i], hv[j], dyh[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = q0 + ty + 16 * i;
        const float e = t < Q ? ev[t] : 0.0f;
        float part = 0.0f;
#pragma unroll
        for (int j = 0; j < kNB; ++j) {
          const int n = tx + 16 * j;
          if (n < N) part = fmaf(Cs[(ty + 16 * i) * ldn + n], dyh[i][j], part);
        }
        part = half_warp_sum(part);
        if (t < Q) {
          if (tx == 0) inter[t] = part * e;
#pragma unroll
          for (int j = 0; j < kNB; ++j) {
            const int n = tx + 16 * j;
            if (n < N)
              dCb[(long long)(c0 + t) * hn + n] =
                  __fadd_rn(dcv[i][j], __fmul_rn(e, dyh[i][j]));
          }
        }
      }
      __syncthreads();
    }

    // pass B, by key tile: dxdt_s = Σ_t (CB∘L)[t,s] dy_t, dB_s = Σ_t
    // dCB[t,s] C_t, the column sums of DL, then the state terms
    for (int k0 = 0; k0 < Q; k0 += kT) {
      load_rows(Bs, ldn, Bc, q.brow, k0, Q, N, nullptr, nullptr);
      load_rows(Xs, kLdX, xc, q.xrow, k0, Q, P, dts, nullptr);
      TC_DMA(2);
      float dbv[4][kNB];                 // s = ty+16i, n = tx+16j
      float dxd[4][PJ];                  // s = ty+16i, p = tx+16j
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < kNB; ++j) dbv[i][j] = 0.0f;
#pragma unroll
        for (int j = 0; j < PJ; ++j) dxd[i][j] = 0.0f;
      }
      for (int q0 = k0; q0 < Q; q0 += kT) {
        load_rows(Cs, ldn, Cc, q.brow, q0, Q, N, nullptr, nullptr);
        load_rows(Ds, kLdX, dyc, q.xrow, q0, Q, P, nullptr, nullptr);
        TC_DMA(2);
        __syncthreads();
        float cb[4][4], dcb[4][4];
        score_tile(Cs, Bs, ldn, N, tx, ty, cb);
        score_tile(Ds, Xs, kLdX, P, tx, ty, dcb);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float l =
                decay(cum, q0 + ty + 16 * i, k0 + tx + 16 * j, Q);
            dcb[i][j] = dcb[i][j] * l;
            T1[(ty + 16 * i) * kLdT + tx + 16 * j] = cb[i][j] * l;
            T2[(ty + 16 * i) * kLdT + tx + 16 * j] = dcb[i][j];
          }
        __syncthreads();
        const int rows = min(kT, Q - q0);
        for (int t = 0; t < rows; ++t) {
          float m1[4], dc[4], dv[PJ], cv[kNB];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            m1[i] = T1[t * kLdT + ty + 16 * i];
            dc[i] = T2[t * kLdT + ty + 16 * i];
          }
#pragma unroll
          for (int j = 0; j < PJ; ++j) dv[j] = Ds[t * kLdX + tx + 16 * j];
#pragma unroll
          for (int j = 0; j < kNB; ++j)
            cv[j] = (tx + 16 * j < N) ? Cs[t * ldn + tx + 16 * j] : 0.0f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < PJ; ++j)
              dxd[i][j] = fmaf(m1[i], dv[j], dxd[i][j]);
#pragma unroll
            for (int j = 0; j < kNB; ++j)
              dbv[i][j] = fmaf(dc[i], cv[j], dbv[i][j]);
          }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            T1[(ty + 16 * i) * kLdT + tx + 16 * j] = dcb[i][j] * cb[i][j];
        __syncthreads();
        if (tid < kT && k0 + tid < Q) {
          float acc = 0.0f;
          double acc64 = 0.0;
          for (int t = 0; t < rows; ++t) {
            acc += T1[t * kLdT + tid];
            acc64 += (double)T1[t * kLdT + tid];
          }
          csum[k0 + tid] += acc;
          c64[k0 + tid] += acc64;
        }
        __syncthreads();
      }
      // state terms: XD_s = xdt_s·dh (dB and T_s), w_s B_s·dhᵀ (dxdt)
      float xd[4][kNB];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNB; ++j) xd[i][j] = 0.0f;
      for (int p = 0; p < P; ++p) {
        float xv[4], hv[kNB];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = Xs[(ty + 16 * i) * kLdX + p];
#pragma unroll
        for (int j = 0; j < kNB; ++j)
          hv[j] = (tx + 16 * j < N) ? dH[p * ldn + tx + 16 * j] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kNB; ++j) xd[i][j] = fmaf(xv[i], hv[j], xd[i][j]);
      }
      float bh[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) bh[i][j] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float bv[4], hv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = Bs[(ty + 16 * i) * ldn + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) hv[j] = dH[(tx + 16 * j) * ldn + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) bh[i][j] = fmaf(bv[i], hv[j], bh[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = k0 + ty + 16 * i;
        const bool in = s < Q;
        const float w = in ? wend[s] : 0.0f;
        float tpart = 0.0f, xpart = 0.0f;
#pragma unroll
        for (int j = 0; j < kNB; ++j) {
          const int n = tx + 16 * j;
          if (n < N) {
            tpart = fmaf(xd[i][j], Bs[(ty + 16 * i) * ldn + n], tpart);
            if (in)
              dBb[(long long)(c0 + s) * hn + n] =
                  __fadd_rn(dbv[i][j], __fmul_rn(w, xd[i][j]));
          }
        }
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          if (!in) continue;
          const int p = tx + 16 * j;
          const float dxdt = __fadd_rn(dxd[i][j], __fmul_rn(w, bh[i][j]));
          const long long at = (long long)(c0 + s) * q.xrow + p;
          dxb[at] = dxdt * dts[s];
          xpart = fmaf(dxdt, xc[(long long)s * q.xrow + p], xpart);
        }
        tpart = half_warp_sum(tpart);
        xpart = half_warp_sum(xpart);
        if (in && tx == 0) {
          tw[s] = tpart * w;
          dxx[s] = xpart;
        }
      }
      __syncthreads();
    }

    // pass C: dcum, the suffix sum to du, ddt; then dh ← E_Q dh + dh_y.
    // du_s = (Σ dcum + last) − Σ_{t≤s} dcum + dcum_s is summed in fp64, as
    // the plain version sums it: the common offset Σ dcum + last reaches
    // every du_s, and through dA = Σ_s du_s·dt_s an fp32 rounding of it
    // would be multiplied by Σ_s dt_s. The chunk's partial of dA,
    // Σ_s du_s·dt_s, is taken from a du formed in fp64 throughout, from
    // DL's fp64 row and column sums: the sum cancels, and their fp32 sums
    // would carry ~1e-5 into it.
    double part = 0.0;
    for (long long e = tid; e < pn; e += kThreads) {
      const long long at = (e / N) * ldn + e % N;
      part += (double)dH[at] * (double)Hin[at];
    }
    red[tid] = part;
    __syncthreads();
    if (tid == 0) {
      double dhh = 0.0, tws = 0.0, total = 0.0;
      for (int k = 0; k < kThreads; ++k) dhh += red[k];
      for (int s = 0; s < Q; ++s) tws += (double)tw[s];
      const double last = (double)expf(cum[Q - 1]) * dhh + tws;
      for (int s = 0; s < Q; ++s) {
        const float d = ((rsum[s] - csum[s]) + inter[s]) - tw[s];
        rsum[s] = d;
        total += (double)d;
      }
      double cs = 0.0;
      for (int s = 0; s < Q; ++s) {
        cs += (double)rsum[s];
        csum[s] = (float)(((total + last) - cs) + (double)rsum[s]);
      }
      double total64 = 0.0;
      for (int s = 0; s < Q; ++s) {
        r64[s] = ((r64[s] - c64[s]) + (double)inter[s]) - (double)tw[s];
        total64 += r64[s];
      }
      double cs64 = 0.0, da = 0.0;
      for (int s = 0; s < Q; ++s) {
        cs64 += r64[s];
        da += (((total64 + last) - cs64) + r64[s]) * (double)dts[s];
      }
      dapb[c] = da;
    }
    __syncthreads();
    for (int s = tid; s < Q; s += kThreads) {
      const float u = csum[s];
      dub[(long long)(c0 + s) * H] = u;
      ddtb[(long long)(c0 + s) * H] = __fadd_rn(dxx[s], __fmul_rn(u, a));
    }
    // dh_y[p][n] = Σ_t dy_t[p] e_t C_t[n]; thread: p = ty+16i, n = tx+16j
    float dhy[PJ][kNB];
#pragma unroll
    for (int i = 0; i < PJ; ++i)
#pragma unroll
      for (int j = 0; j < kNB; ++j) dhy[i][j] = 0.0f;
    for (int q0 = 0; q0 < Q; q0 += kT) {
      load_rows(Ds, kLdX, dyc, q.xrow, q0, Q, P, ev, nullptr);
      load_rows(Cs, ldn, Cc, q.brow, q0, Q, N, nullptr, nullptr);
      TC_DMA(2);
      __syncthreads();
      const int rows = min(kT, Q - q0);
      for (int t = 0; t < rows; ++t) {
        float dv[PJ], cv[kNB];
#pragma unroll
        for (int i = 0; i < PJ; ++i) dv[i] = Ds[t * kLdX + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kNB; ++j)
          cv[j] = (tx + 16 * j < N) ? Cs[t * ldn + tx + 16 * j] : 0.0f;
#pragma unroll
        for (int i = 0; i < PJ; ++i)
#pragma unroll
          for (int j = 0; j < kNB; ++j)
            dhy[i][j] = fmaf(dv[i], cv[j], dhy[i][j]);
      }
      __syncthreads();
    }
    const float E = expf(cum[Q - 1]);
#pragma unroll
    for (int i = 0; i < PJ; ++i)
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const int n = tx + 16 * j;
        if (n < N) {
          float& hv = dH[(ty + 16 * i) * ldn + n];
          hv = __fadd_rn(__fmul_rn(hv, E), dhy[i][j]);
        }
      }
    __syncthreads();
  }
  TC_FLUSH(tid == 0);
}

// ---------------------------------------------------------------------------
// K9, mma variant: dh per chunk, then the chunks in parallel on 3×TF32
// tensor cores (see the header)
// ---------------------------------------------------------------------------
constexpr int kBT = 64;           // rows of a K9 tile: queries (dC) or keys
constexpr int kBS = 32;           // keys (dC) or queries (dB) of a ring stage
constexpr int kBThreads = 128;    // 4 warps of 16 rows of the tile
constexpr int kNT = kMaxN / 8;    // n8 tiles over N, at most
constexpr int kDuWarps = 8;       // (row, head, chunk) triples of a du block
constexpr int kSumThreads = 256;

__global__ void __launch_bounds__(kCumHeads)
ssd_bwd_cum_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                   const int* __restrict__ ha, float* __restrict__ cum,
                   int S, int H, int Q) {
  extern __shared__ float tile[];
  cum_body(dt, A, ha, cum, S, H, Q, tile);
}

__global__ void __launch_bounds__(kCbThreads)
ssd_bwd_cb_kernel(const float* __restrict__ B, const float* __restrict__ C,
                  const int* __restrict__ ha, float* __restrict__ cb, int S,
                  int H, int G, int N, int Q, int Qp) {
  extern __shared__ __align__(16) float smem[];
  cb_body(B, C, ha, cb, S, H, G, N, Q, Qp, smem);
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&h)[4],
                                       uint32_t (&l)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) tf32x3::split(a[q], h[q], l[q]);
}

// Sum over the 4 lanes of a row of an mma tile (t = lane % 4).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ double quad_sum(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Rows [row0, row0 + rows) of a chunk slice whose row i starts at
// src + i·stride, `width` floats each (a multiple of 4), into
// dst[i·ld + k] by 16-byte cp.async; rows at or past `valid` are written
// as zeros and not read.
__device__ __forceinline__ void cp_rows(float* dst, int ld,
                                        const float* __restrict__ src,
                                        long long stride, int row0, int rows,
                                        int valid, int width, int nthreads) {
  const int w4 = width / 4;
  for (int e = threadIdx.x; e < rows * w4; e += nthreads) {
    const int i = e / w4, k = (e - i * w4) * 4;
    const bool in = row0 + i < valid;
    tf32x3::cp_async16(dst + i * ld + k,
                       in ? src + (long long)(row0 + i) * stride + k : src,
                       in ? 16 : 0);
  }
}

// Shared memory of `ssd_bwd_dh_kernel<PT>`: the dh slice, the ring of dy
// and C stages, e^{cum_t} and one double a warp.
__host__ __device__ constexpr size_t mma_dh_floats(int PT, int N, int Qr) {
  return (size_t)PT * (N + 8) + (size_t)kStages * kKT * (PT + 4 + N + 4) +
         (size_t)Qr + 16;
}

// The cotangent of the state leaving each chunk but the last (where it is
// 0): a block per (row, head, PT columns of P), 8 warps, chunks in reverse.
// dh leaving chunk c − 1 = e^{cum_Q(c)}·dh_c + Σ_t (e_t dy_t)ᵀ C_t, the sum
// over the chunk's Q tokens on the tensor cores (warp w: rows [wp, wp + 16)
// of the slice × columns [wn, wn + 8·NT) of N; dy and C through the same
// 3-stage cp.async ring as ssd_fwd_mma_kernel's state update). Writes
// dhs[r, c − 1, h] (R, S/Q − 1, H, P, N) and the slice's Σ dh∘h_in of that
// chunk in fp64 (dhh, (R, H, S/Q, P / PT): the `last` term of du). A dead
// head writes nothing: no later kernel reads it.
template <int PT>
__global__ void __launch_bounds__(kMmaThreads, 2)
ssd_bwd_dh_kernel(const float* __restrict__ dy, const float* __restrict__ C,
                  const float* __restrict__ cum,
                  const float* __restrict__ states,
                  const int* __restrict__ ha, float* __restrict__ dhs,
                  double* __restrict__ dhh, int S, int H, int P, int G,
                  int N, int Q) {
  constexpr int NT = PT / 8;
  constexpr int WARPS_P = PT / 16;
  constexpr int WARPS_N = 8 / WARPS_P;
  constexpr int LDX = PT + 4;
  extern __shared__ __align__(16) float smem[];
  const int ldh = N + 8, ldb = N + 4;
  const int Qr = (Q + kKT - 1) / kKT * kKT;
  const int stage_floats = kKT * (LDX + ldb);
  float* hs = smem;                           // [PT][ldh] dh slice
  float* ring = hs + PT * ldh;                // kStages × (dy tile, C tile)
  float* ev = ring + kStages * stage_floats;  // [Qr] e^{cum_t}
  double* red = reinterpret_cast<double*>(ev + Qr);  // [8]

  const int slices = P / PT;
  const int ps = blockIdx.x % slices;
  const int h = (blockIdx.x / slices) % H, r = blockIdx.x / (slices * H);
  const int p0 = ps * PT, grp = h / (H / G), nc = S / Q;
  if (!head_live(ha, r, h)) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long xrow = (long long)H * P, brow = (long long)G * N;
  const long long pn = (long long)P * N;
  const float* dyb = dy + (long long)r * S * xrow + (long long)h * P + p0;
  const float* Cb = C + (long long)r * S * brow + (long long)grp * N;
  const float* cumb = cum + ((long long)r * H + h) * S;
  for (int e = tid; e < PT * ldh; e += kMmaThreads) hs[e] = 0.0f;
  const int wp = (warp / WARPS_N) * 16, wn = (warp % WARPS_N) * 8 * NT;
  const int n_kt = Qr / kKT;
  TC_DECL;  // a chunk a tile; a stage's dy and C tiles 2 blocks

  for (int c = nc - 1; c >= 1; --c) {
    const int c0 = c * Q;
    const float* dyc = dyb + (long long)c0 * xrow;
    const float* Cc = Cb + (long long)c0 * brow;
    TC_TILES(1);
    auto load_stage = [&](int kt) {
      float* xs = ring + (kt % kStages) * stage_floats;
      float* bs = xs + kKT * LDX;
      TC_DMA(2);
      cp_rows(xs, LDX, dyc, xrow, kt * kKT, kKT, Q, PT, kMmaThreads);
      cp_rows(bs, ldb, Cc, brow, kt * kKT, kKT, Q, N, kMmaThreads);
    };
    __syncthreads();                 // the ring and ev are free again
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < n_kt) load_stage(k);
      tf32x3::cp_async_commit();
    }
    for (int i = tid; i < Qr; i += kMmaThreads)
      ev[i] = i < Q ? expf(cumb[c0 + i]) : 0.0f;
    float hacc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) hacc[j][q] = 0.0f;
    for (int kt = 0; kt < n_kt; ++kt) {
      tf32x3::cp_async_wait<kStages - 2>();  // stage kt has landed
      __syncthreads();  // ... for every thread; stage kt - 1 is free again
      if (kt + kStages - 1 < n_kt) load_stage(kt + kStages - 1);
      tf32x3::cp_async_commit();
      const float* xs = ring + (kt % kStages) * stage_floats;
      const float* bs = xs + kKT * LDX;
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 8) {
        const int sa = kt * kKT + kk + 2 * t;
        const float ea = ev[sa], eb = ev[sa + 1];
        // A = (e·dy)ᵀ: rows p, keys sa, sb (the permuted k order)
        const float* xa = xs + (kk + 2 * t) * LDX + wp + g;
        const float* xb = xa + LDX;
        float a[4] = {__fmul_rn(xa[0], ea), __fmul_rn(xa[8], ea),
                      __fmul_rn(xb[0], eb), __fmul_rn(xb[8], eb)};
        uint32_t ah[4], al[4];
        split4(a, ah, al);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = wn + j * 8 + g;
          if (wn + j * 8 >= N) continue;
          uint32_t bh[2], bl[2];
          tf32x3::split(bs[(kk + 2 * t) * ldb + n], bh[0], bl[0]);
          tf32x3::split(bs[(kk + 2 * t + 1) * ldb + n], bh[1], bl[1]);
          tf32x3::mma3_add(hacc[j], ah, al, bh, bl);
        }
      }
    }
    tf32x3::cp_async_wait<0>();
    // dh ← e^{cum_Q} dh + Σ_t (e_t dy_t)ᵀ C_t: each value owned by one
    // thread (no barrier needed between its read and write)
    const float E = expf(cumb[c0 + Q - 1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = wn + j * 8 + 2 * t;
      if (wn + j * 8 >= N) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* hv = hs + (wp + g + 8 * hh) * ldh + n;
        hv[0] = __fadd_rn(__fmul_rn(hv[0], E), hacc[j][2 * hh]);
        hv[1] = __fadd_rn(__fmul_rn(hv[1], E), hacc[j][2 * hh + 1]);
      }
    }
    __syncthreads();
    // the cotangent leaving chunk c − 1, and Σ dh∘h_in of that chunk
    const long long at = (((long long)r * (nc - 1) + (c - 1)) * H + h) * pn +
                         (long long)p0 * N;
    const float* hin = states + (((long long)r * nc + (c - 1)) * H + h) * pn +
                       (long long)p0 * N;
    double part = 0.0;
    for (int e = tid; e < PT * N; e += kMmaThreads) {
      const float v = hs[(e / N) * ldh + e % N];
      dhs[at + e] = v;
      part += (double)v * (double)hin[e];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (tid == 0) {
      double sum = 0.0;
      for (int w = 0; w < kMmaThreads / 32; ++w) sum += red[w];
      dhh[(((long long)r * H + h) * nc + (c - 1)) * slices + ps] = sum;
    }
  }
  TC_FLUSH(tid == 0);
}

// The block of a K9 tile kernel: the grid runs the tiles with the most
// causal work first (rank 0), then (row, chunk, group, head slice) with
// the slice fastest, so that the slices of one tile share B, C and C·Bᵀ
// through L2.
struct BwdTile {
  int rank, r, c, grp, sl;
};

__device__ __forceinline__ BwdTile bwd_tile(int R, int nc, int G, int ns) {
  const int per = R * nc * G * ns;
  BwdTile b;
  b.rank = blockIdx.x / per;
  int rest = blockIdx.x - b.rank * per;
  b.sl = rest % ns;
  rest /= ns;
  b.grp = rest % G;
  rest /= G;
  b.c = rest % nc;
  b.r = rest / nc;
  return b;
}

// Shared memory of the two tile kernels: a 64-row tile of P and one of N
// (the tile's own dy or x, and C or B), a two-deep ring of 32-row stages
// of P and N (whose space then holds h_in or dh, P × (N + 8)) and two chunk
// vectors.
__host__ __device__ constexpr size_t mma_tile_floats(int P, int N, int Qp) {
  return (size_t)kBT * (P + 4) + (size_t)kBT * (N + 8) +
         2 * (size_t)kBS * (P + 4 + N + 4) + 2 * (size_t)Qp;
}

// K9's query tiles: a block per (64 queries t, row, chunk, head slice of a
// group), 4 warps of 16 queries. For each live head of the slice, in head
// order: dG = dy_t·xdt_sᵀ over P, dCB = dG∘L (masked before the
// exponential), the row sums of DL = dCB∘CB, dC_t += Σ_{s≤t} dCB[t,s] B_s
// over the keys s ≤ t (32-key stages of x and B through a two-deep ring,
// 8 keys an mma step: the dG tile of a step is the A fragment of the dC
// product, register for register); then dy·h_in over P (h_in staged in
// the ring's space), dC_t += e_t (dy·h_in)_t and inter_t = e_t Σ_n C_t ∘
// (dy·h_in)_t. dC accumulates over the slice's heads in registers and
// leaves once, per group (a partial per slice when a group has several).
template <int P>
__global__ void __launch_bounds__(kBThreads, 2)
ssd_bwd_dc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ B, const float* __restrict__ C,
                  const float* __restrict__ cb, const float* __restrict__ cum,
                  const float* __restrict__ states,
                  const float* __restrict__ dy, const int* __restrict__ ha,
                  float* __restrict__ dCp, float* __restrict__ rsum,
                  double* __restrict__ rsum64, float* __restrict__ inter,
                  int R, int S, int H, int G, int N, int Q, int Qp, int hs,
                  int ns) {
  constexpr int LDP = P + 4, KP = P / 8;
  extern __shared__ __align__(16) float smem[];
  const int ldc = N + 8, ldb = N + 4, ldh = N + 8;
  float* Ct = smem;                       // [kBT][ldc] C rows of the tile
  float* Dy = Ct + kBT * ldc;             // [kBT][LDP] dy rows of the tile
  float* ring = Dy + kBT * LDP;           // 2 × (x [kBS][LDP], B [kBS][ldb])
  const int stage = kBS * (LDP + ldb);
  float* cumv = ring + 2 * stage;         // [Qp]
  float* dts = cumv + Qp;                 // [Qp]

  const int nc = S / Q, tiles = Qp / kBT, rep = H / G;
  const BwdTile bt = bwd_tile(R, nc, G, ns);
  const int r = bt.r, c = bt.c, grp = bt.grp;
  const int t0 = (tiles - 1 - bt.rank) * kBT, c0 = c * Q;
  const int h0 = grp * rep + bt.sl * hs;
  const int h1 = min(h0 + hs, (grp + 1) * rep);
  const int hlive = min(h1, ha == nullptr ? H : ha[r]);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long xrow = (long long)H * P, brow = (long long)G * N;
  float* out = dCp + (long long)bt.sl * R * S * brow +
               ((long long)r * S + c0) * brow + (long long)grp * N;
  const int rows = min(kBT, Q - t0);
  if (h0 >= hlive) {                      // no live head: zeros
    for (int e = tid; e < rows * N; e += kBThreads)
      out[(long long)(t0 + e / N) * brow + e % N] = 0.0f;
    return;
  }
  const float* Cc = C + ((long long)r * S + c0) * brow + (long long)grp * N;
  const float* Bc = B + ((long long)r * S + c0) * brow + (long long)grp * N;
  TC_DECL;  // a (live head, 32-key stage) a tile; the C tile once, a
            // head's dy tile and h_in, a stage's x and B tiles 2 blocks
  cp_rows(Ct, ldc, Cc, brow, t0, kBT, Q, N, kBThreads);
  TC_DMA(1);
  tf32x3::cp_async_commit();

  const int nt = N / 8;
  const int tw = t0 + warp * 16;          // the warp's first query
  const int ta = tw + g, tb = ta + 8;     // this thread's queries
  const int wr = warp * 16 + g;           // ... as rows of the tile
  const int kend = min(t0 + kBT, Q);      // keys s < kend
  const int n_steps = (kend + kBS - 1) / kBS;
  const float* cbz = cb + ((long long)(r * G + grp) * nc + c) * Qp * Qp;
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;

  for (int h = h0; h < hlive; ++h) {
    const long long xo = ((long long)r * S + c0) * xrow + (long long)h * P;
    auto load_step = [&](int k) {
      float* xs = ring + (k & 1) * stage;
      cp_rows(xs, LDP, x + xo, xrow, k * kBS, kBS, Q, P, kBThreads);
      cp_rows(xs + kBS * LDP, ldb, Bc, brow, k * kBS, kBS, Q, N, kBThreads);
      TC_DMA(2);
    };
    __syncthreads();                      // the last head is done with all
    cp_rows(Dy, LDP, dy + xo, xrow, t0, kBT, Q, P, kBThreads);
    TC_DMA(1);
    load_step(0);
    tf32x3::cp_async_commit();
    const float* cumh = cum + ((long long)r * H + h) * S + c0;
    const float* dth = dt + ((long long)r * S + c0) * H + h;
    for (int i = tid; i < Qp; i += kBThreads) {
      cumv[i] = i < Q ? cumh[i] : 0.0f;
      dts[i] = i < Q ? dth[(long long)i * H] : 0.0f;
    }
    float rs_a = 0.0f, rs_b = 0.0f;       // Σ_s DL of rows ta, tb
    double ra64 = 0.0, rb64 = 0.0;        // the same sums in fp64 (dA)
    for (int k = 0; k < n_steps; ++k) {
      TC_TILES(1);
      if (k > 0) __syncthreads();         // stage (k + 1) & 1 is free
      if (k + 1 < n_steps) load_step(k + 1);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();         // step k has landed
      __syncthreads();
      const float* xs = ring + (k & 1) * stage;
      const float* bs = xs + kBS * LDP;
#pragma unroll
      for (int j8 = 0; j8 < kBS; j8 += 8) {
        const int s8 = k * kBS + j8;
        if (s8 > tw + 15 || s8 >= kend) continue;  // above the diagonal
        // dG (16 queries × 8 keys) over P: B = xdt rows s8 + g
        const float dsg = dts[s8 + g];
        float dg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kp = 0; kp < KP; ++kp) {
          const int k0 = kp * 8;
          float a[4] = {Dy[wr * LDP + k0 + t], Dy[(wr + 8) * LDP + k0 + t],
                        Dy[wr * LDP + k0 + t + 4],
                        Dy[(wr + 8) * LDP + k0 + t + 4]};
          uint32_t ah[4], al[4], bh[2], bl[2];
          split4(a, ah, al);
          tf32x3::split(__fmul_rn(xs[(j8 + g) * LDP + k0 + t], dsg), bh[0],
                        bl[0]);
          tf32x3::split(__fmul_rn(xs[(j8 + g) * LDP + k0 + t + 4], dsg),
                        bh[1], bl[1]);
          tf32x3::mma3_add(dg, ah, al, bh, bl);
        }
        // element q: query (q < 2 ? ta : tb), key s8 + 2t + (q & 1)
        float dcb[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int tt = q < 2 ? ta : tb, ss = s8 + 2 * t + (q & 1);
          const bool in = ss <= tt && tt < Q;
          // masked before the exponential: −∞ above the diagonal
          const float l = expf(in ? cumv[tt] - cumv[ss] : -INFINITY);
          dcb[q] = in ? __fmul_rn(dg[q], l) : 0.0f;
          const float dl =
              in ? __fmul_rn(dcb[q], cbz[(long long)tt * Qp + ss]) : 0.0f;
          if (q < 2) {
            rs_a += dl;
            ra64 += (double)dl;
          } else {
            rs_b += dl;
            rb64 += (double)dl;
          }
        }
        // dC += dCB · B_s over the 8 keys (k = 2t in slot t, 2t + 1 in
        // slot t + 4: the dG tile is the A fragment as it stands)
        const float af[4] = {dcb[0], dcb[2], dcb[1], dcb[3]};
        uint32_t ah[4], al[4];
        split4(af, ah, al);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if (j >= nt) break;
          uint32_t bh[2], bl[2];
          tf32x3::split(bs[(j8 + 2 * t) * ldb + j * 8 + g], bh[0], bl[0]);
          tf32x3::split(bs[(j8 + 2 * t + 1) * ldb + j * 8 + g], bh[1],
                        bl[1]);
          tf32x3::mma3_add(acc[j], ah, al, bh, bl);
        }
      }
    }
    // h_in of the head into the ring's space, then dy·h_in over P
    tf32x3::cp_async_wait<0>();
    __syncthreads();                      // every warp is done with the ring
    const float* hin =
        states + (((long long)r * nc + c) * H + h) * (long long)P * N;
    cp_rows(ring, ldh, hin, N, 0, P, P, N, kBThreads);
    TC_DMA(1);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<0>();
    __syncthreads();
    const float ea = ta < Q ? expf(cumv[ta]) : 0.0f;
    const float eb = tb < Q ? expf(cumv[tb]) : 0.0f;
    float ia = 0.0f, ib = 0.0f;           // Σ_n C_t ∘ (dy·h_in)_t
#pragma unroll
    for (int jb = 0; jb < kNT; jb += 4) {
      if (jb >= nt) break;
      float tmp[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int q = 0; q < 4; ++q) tmp[jj][q] = 0.0f;
#pragma unroll
      for (int kp = 0; kp < KP; ++kp) {
        const int k0 = kp * 8;
        float a[4] = {Dy[wr * LDP + k0 + t], Dy[(wr + 8) * LDP + k0 + t],
                      Dy[wr * LDP + k0 + t + 4],
                      Dy[(wr + 8) * LDP + k0 + t + 4]};
        uint32_t ah[4], al[4];
        split4(a, ah, al);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int n = (jb + jj) * 8 + g;
          if (jb + jj >= nt) break;
          uint32_t bh[2], bl[2];
          tf32x3::split(ring[(k0 + t) * ldh + n], bh[0], bl[0]);
          tf32x3::split(ring[(k0 + t + 4) * ldh + n], bh[1], bl[1]);
          tf32x3::mma3_add(tmp[jj], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = jb + jj;
        if (j >= nt) break;
        const int n = j * 8 + 2 * t;
        const float2 ca = *reinterpret_cast<const float2*>(Ct + wr * ldc + n);
        const float2 cv =
            *reinterpret_cast<const float2*>(Ct + (wr + 8) * ldc + n);
        acc[j][0] = __fadd_rn(acc[j][0], __fmul_rn(ea, tmp[jj][0]));
        acc[j][1] = __fadd_rn(acc[j][1], __fmul_rn(ea, tmp[jj][1]));
        acc[j][2] = __fadd_rn(acc[j][2], __fmul_rn(eb, tmp[jj][2]));
        acc[j][3] = __fadd_rn(acc[j][3], __fmul_rn(eb, tmp[jj][3]));
        ia = fmaf(ca.x, tmp[jj][0], fmaf(ca.y, tmp[jj][1], ia));
        ib = fmaf(cv.x, tmp[jj][2], fmaf(cv.y, tmp[jj][3], ib));
      }
    }
    rs_a = quad_sum(rs_a);
    rs_b = quad_sum(rs_b);
    ra64 = quad_sum(ra64);
    rb64 = quad_sum(rb64);
    ia = quad_sum(ia);
    ib = quad_sum(ib);
    if (t == 0) {
      const long long o = ((long long)r * H + h) * S + c0;
      if (ta < Q) {
        rsum[o + ta] = rs_a;
        rsum64[o + ta] = ra64;
        inter[o + ta] = __fmul_rn(ia, ea);
      }
      if (tb < Q) {
        rsum[o + tb] = rs_b;
        rsum64[o + tb] = rb64;
        inter[o + tb] = __fmul_rn(ib, eb);
      }
    }
  }
  // dC of the slice's heads, rows t < Q
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j >= nt) break;
    const int n = j * 8 + 2 * t;
    if (ta < Q)
      *reinterpret_cast<float2*>(out + (long long)ta * brow + n) =
          make_float2(acc[j][0], acc[j][1]);
    if (tb < Q)
      *reinterpret_cast<float2*>(out + (long long)tb * brow + n) =
          make_float2(acc[j][2], acc[j][3]);
  }
  TC_FLUSH(tid == 0);
}

// K9's key tiles: a block per (64 keys s, row, chunk, head slice of a
// group), 4 warps of 16 keys. For each live head of the slice, in head
// order, over the queries t ≥ s (32-query stages of dy and C through a
// two-deep ring, 8 queries an mma step): dGᵀ = xdt_s·dy_tᵀ over P,
// dCBᵀ = dGᵀ∘Lᵀ and (L∘CB)ᵀ (masked before the exponential), the column
// sums of DL, dB_s += Σ_t dCB[t,s] C_t and dxdt_s += Σ_t (L∘CB)[t,s] dy_t;
// then, but in the last chunk (where dh = 0), the state terms with dh
// staged in the ring's space: XD = xdt·dh over P (dB_s += w_s XD_s and
// T_s = Σ_n XD_s∘B_s) and dxdt_s += w_s B_s·dhᵀ over N. Writes dx =
// dxdt·dt, Σ_p dxdt·x (into ddt, which the du pass completes), the column
// sums and T·w per head; dB accumulates over the slice's heads in
// registers and leaves once, per group. A dead head of the slice gets
// dx = 0 here.
template <int P>
__global__ void __launch_bounds__(kBThreads, 2)
ssd_bwd_dbx_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ B, const float* __restrict__ C,
                   const float* __restrict__ cb,
                   const float* __restrict__ cum,
                   const float* __restrict__ dhs,
                   const float* __restrict__ dy, const int* __restrict__ ha,
                   float* __restrict__ dx, float* __restrict__ ddt,
                   float* __restrict__ dBp, float* __restrict__ csum,
                   double* __restrict__ csum64, float* __restrict__ twv,
                   int R, int S, int H, int G, int N, int Q, int Qp, int hs,
                   int ns) {
  constexpr int LDP = P + 4, KP = P / 8;
  extern __shared__ __align__(16) float smem[];
  const int ldk = N + 8, ldc = N + 4, ldh = N + 8;
  float* Xk = smem;                       // [kBT][LDP] x rows of the tile
  float* Bk = Xk + kBT * LDP;             // [kBT][ldk] B rows of the tile
  float* ring = Bk + kBT * ldk;           // 2 × (dy [kBS][LDP], C [kBS][ldc])
  const int stage = kBS * (LDP + ldc);
  float* cumv = ring + 2 * stage;         // [Qp]
  float* dts = cumv + Qp;                 // [Qp]

  const int nc = S / Q, rep = H / G;
  const BwdTile bt = bwd_tile(R, nc, G, ns);
  const int r = bt.r, c = bt.c, grp = bt.grp;
  const int s0 = bt.rank * kBT, c0 = c * Q;
  const int h0 = grp * rep + bt.sl * hs;
  const int h1 = min(h0 + hs, (grp + 1) * rep);
  const int hlive = min(h1, ha == nullptr ? H : ha[r]);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long xrow = (long long)H * P, brow = (long long)G * N;
  float* out = dBp + (long long)bt.sl * R * S * brow +
               ((long long)r * S + c0) * brow + (long long)grp * N;
  const int rows = min(kBT, Q - s0);
  // heads of the slice past the prefix: dx = 0
  for (int h = max(h0, hlive); h < h1; ++h)
    for (int e = tid; e < rows * P; e += kBThreads)
      dx[((long long)r * S + c0 + s0 + e / P) * xrow + (long long)h * P +
         e % P] = 0.0f;
  if (h0 >= hlive) {                      // no live head: zeros
    for (int e = tid; e < rows * N; e += kBThreads)
      out[(long long)(s0 + e / N) * brow + e % N] = 0.0f;
    return;
  }
  const float* Cc = C + ((long long)r * S + c0) * brow + (long long)grp * N;
  const float* Bc = B + ((long long)r * S + c0) * brow + (long long)grp * N;
  TC_DECL;  // a (live head, 32-query stage) a tile; the B tile once, a
            // head's x tile and dh, a stage's dy and C tiles 2 blocks
  cp_rows(Bk, ldk, Bc, brow, s0, kBT, Q, N, kBThreads);
  TC_DMA(1);
  tf32x3::cp_async_commit();

  const int nt = N / 8;
  const int sw = s0 + warp * 16;          // the warp's first key
  const int sa = sw + g, sb = sa + 8;     // this thread's keys
  const int wr = warp * 16 + g;           // ... as rows of the tile
  const int n_steps = (Q - s0 + kBS - 1) / kBS;
  const bool state = c < nc - 1;          // dh leaving the last chunk is 0
  const float* cbz = cb + ((long long)(r * G + grp) * nc + c) * Qp * Qp;
  float dbacc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) dbacc[j][q] = 0.0f;

  for (int h = h0; h < hlive; ++h) {
    const long long xo = ((long long)r * S + c0) * xrow + (long long)h * P;
    auto load_step = [&](int k) {
      float* ys = ring + (k & 1) * stage;
      cp_rows(ys, LDP, dy + xo, xrow, s0 + k * kBS, kBS, Q, P, kBThreads);
      cp_rows(ys + kBS * LDP, ldc, Cc, brow, s0 + k * kBS, kBS, Q, N,
              kBThreads);
      TC_DMA(2);
    };
    __syncthreads();                      // the last head is done with all
    cp_rows(Xk, LDP, x + xo, xrow, s0, kBT, Q, P, kBThreads);
    TC_DMA(1);
    load_step(0);
    tf32x3::cp_async_commit();
    const float* cumh = cum + ((long long)r * H + h) * S + c0;
    const float* dth = dt + ((long long)r * S + c0) * H + h;
    for (int i = tid; i < Qp; i += kBThreads) {
      cumv[i] = i < Q ? cumh[i] : 0.0f;
      dts[i] = i < Q ? dth[(long long)i * H] : 0.0f;
    }
    float dxa[KP][4];                     // dxdt of keys sa, sb over P
#pragma unroll
    for (int j = 0; j < KP; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) dxa[j][q] = 0.0f;
    float cs_a = 0.0f, cs_b = 0.0f;       // Σ_t DL of keys sa, sb
    double ca64 = 0.0, cb64 = 0.0;        // the same sums in fp64 (dA)
    for (int k = 0; k < n_steps; ++k) {
      TC_TILES(1);
      if (k > 0) __syncthreads();         // stage (k + 1) & 1 is free
      if (k + 1 < n_steps) load_step(k + 1);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();         // step k has landed
      __syncthreads();
      const float* ys = ring + (k & 1) * stage;
      const float* cs = ys + kBS * LDP;
      const float da = dts[sa], db = dts[sb];
#pragma unroll
      for (int j8 = 0; j8 < kBS; j8 += 8) {
        const int q8 = s0 + k * kBS + j8;
        if (q8 + 7 < sw || q8 >= Q) continue;  // all before the warp's keys
        // dGᵀ (16 keys × 8 queries) over P: A = xdt rows sa, sb; B = dy
        float dg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kp = 0; kp < KP; ++kp) {
          const int k0 = kp * 8;
          float a[4] = {__fmul_rn(Xk[wr * LDP + k0 + t], da),
                        __fmul_rn(Xk[(wr + 8) * LDP + k0 + t], db),
                        __fmul_rn(Xk[wr * LDP + k0 + t + 4], da),
                        __fmul_rn(Xk[(wr + 8) * LDP + k0 + t + 4], db)};
          uint32_t ah[4], al[4], bh[2], bl[2];
          split4(a, ah, al);
          tf32x3::split(ys[(j8 + g) * LDP + k0 + t], bh[0], bl[0]);
          tf32x3::split(ys[(j8 + g) * LDP + k0 + t + 4], bh[1], bl[1]);
          tf32x3::mma3_add(dg, ah, al, bh, bl);
        }
        // element q: key (q < 2 ? sa : sb), query q8 + 2t + (q & 1)
        float dcb[4], m[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ss = q < 2 ? sa : sb, tt = q8 + 2 * t + (q & 1);
          const bool in = ss <= tt && tt < Q;
          const float cv = in ? cbz[(long long)tt * Qp + ss] : 0.0f;
          const float l = expf(in ? cumv[tt] - cumv[ss] : -INFINITY);
          dcb[q] = in ? __fmul_rn(dg[q], l) : 0.0f;
          m[q] = in ? __fmul_rn(cv, l) : 0.0f;
          const float dl = __fmul_rn(dcb[q], cv);
          if (q < 2) {
            cs_a += dl;
            ca64 += (double)dl;
          } else {
            cs_b += dl;
            cb64 += (double)dl;
          }
        }
        // dB += dCBᵀ · C_t and dxdt += (L∘CB)ᵀ · dy_t over the 8 queries
        const float af[4] = {dcb[0], dcb[2], dcb[1], dcb[3]};
        const float mf[4] = {m[0], m[2], m[1], m[3]};
        uint32_t ah[4], al[4];
        split4(af, ah, al);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if (j >= nt) break;
          uint32_t bh[2], bl[2];
          tf32x3::split(cs[(j8 + 2 * t) * ldc + j * 8 + g], bh[0], bl[0]);
          tf32x3::split(cs[(j8 + 2 * t + 1) * ldc + j * 8 + g], bh[1],
                        bl[1]);
          tf32x3::mma3_add(dbacc[j], ah, al, bh, bl);
        }
        split4(mf, ah, al);
#pragma unroll
        for (int j = 0; j < KP; ++j) {
          uint32_t bh[2], bl[2];
          tf32x3::split(ys[(j8 + 2 * t) * LDP + j * 8 + g], bh[0], bl[0]);
          tf32x3::split(ys[(j8 + 2 * t + 1) * LDP + j * 8 + g], bh[1],
                        bl[1]);
          tf32x3::mma3_add(dxa[j], ah, al, bh, bl);
        }
      }
    }
    tf32x3::cp_async_wait<0>();
    const float da = sa < Q ? dts[sa] : 0.0f, db = sb < Q ? dts[sb] : 0.0f;
    float T_a = 0.0f, T_b = 0.0f;         // Σ_n XD∘B of keys sa, sb
    const float wa = sa < Q ? expf(cumv[Q - 1] - cumv[sa]) : 0.0f;
    const float wb = sb < Q ? expf(cumv[Q - 1] - cumv[sb]) : 0.0f;
    if (state) {
      __syncthreads();                    // every warp is done with the ring
      const float* dh = dhs + (((long long)r * (nc - 1) + c) * H + h) *
                                  (long long)P * N;
      cp_rows(ring, ldh, dh, N, 0, P, P, N, kBThreads);
      TC_DMA(1);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<0>();
      __syncthreads();
      // XD = xdt·dh over P; dB += w·XD; T = Σ_n XD∘B
#pragma unroll
      for (int jb = 0; jb < kNT; jb += 4) {
        if (jb >= nt) break;
        float tmp[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int q = 0; q < 4; ++q) tmp[jj][q] = 0.0f;
#pragma unroll
        for (int kp = 0; kp < KP; ++kp) {
          const int k0 = kp * 8;
          float a[4] = {__fmul_rn(Xk[wr * LDP + k0 + t], da),
                        __fmul_rn(Xk[(wr + 8) * LDP + k0 + t], db),
                        __fmul_rn(Xk[wr * LDP + k0 + t + 4], da),
                        __fmul_rn(Xk[(wr + 8) * LDP + k0 + t + 4], db)};
          uint32_t ah[4], al[4];
          split4(a, ah, al);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (jb + jj >= nt) break;
            const int n = (jb + jj) * 8 + g;
            uint32_t bh[2], bl[2];
            tf32x3::split(ring[(k0 + t) * ldh + n], bh[0], bl[0]);
            tf32x3::split(ring[(k0 + t + 4) * ldh + n], bh[1], bl[1]);
            tf32x3::mma3_add(tmp[jj], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = jb + jj;
          if (j >= nt) break;
          const int n = j * 8 + 2 * t;
          const float2 ba = *reinterpret_cast<const float2*>(Bk + wr * ldk + n);
          const float2 bb =
              *reinterpret_cast<const float2*>(Bk + (wr + 8) * ldk + n);
          dbacc[j][0] = __fadd_rn(dbacc[j][0], __fmul_rn(wa, tmp[jj][0]));
          dbacc[j][1] = __fadd_rn(dbacc[j][1], __fmul_rn(wa, tmp[jj][1]));
          dbacc[j][2] = __fadd_rn(dbacc[j][2], __fmul_rn(wb, tmp[jj][2]));
          dbacc[j][3] = __fadd_rn(dbacc[j][3], __fmul_rn(wb, tmp[jj][3]));
          T_a = fmaf(ba.x, tmp[jj][0], fmaf(ba.y, tmp[jj][1], T_a));
          T_b = fmaf(bb.x, tmp[jj][2], fmaf(bb.y, tmp[jj][3], T_b));
        }
      }
      // dxdt += w·(B·dhᵀ) over N, in the permuted k order (64-bit loads)
#pragma unroll
      for (int jb = 0; jb < KP; jb += 4) {
        float tmp[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int q = 0; q < 4; ++q) tmp[jj][q] = 0.0f;
        for (int kn = 0; kn < nt; ++kn) {
          const int k0 = kn * 8 + 2 * t;
          const float2 va = *reinterpret_cast<const float2*>(Bk + wr * ldk + k0);
          const float2 vb =
              *reinterpret_cast<const float2*>(Bk + (wr + 8) * ldk + k0);
          const float a[4] = {va.x, vb.x, va.y, vb.y};
          uint32_t ah[4], al[4];
          split4(a, ah, al);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float2 hv = *reinterpret_cast<const float2*>(
                ring + ((jb + jj) * 8 + g) * ldh + k0);
            uint32_t bh[2], bl[2];
            tf32x3::split(hv.x, bh[0], bl[0]);
            tf32x3::split(hv.y, bh[1], bl[1]);
            tf32x3::mma3_add(tmp[jj], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          dxa[jb + jj][0] =
              __fadd_rn(dxa[jb + jj][0], __fmul_rn(wa, tmp[jj][0]));
          dxa[jb + jj][1] =
              __fadd_rn(dxa[jb + jj][1], __fmul_rn(wa, tmp[jj][1]));
          dxa[jb + jj][2] =
              __fadd_rn(dxa[jb + jj][2], __fmul_rn(wb, tmp[jj][2]));
          dxa[jb + jj][3] =
              __fadd_rn(dxa[jb + jj][3], __fmul_rn(wb, tmp[jj][3]));
        }
      }
    }
    // dx = dxdt·dt and Σ_p dxdt·x of keys sa, sb
    float xa = 0.0f, xb = 0.0f;
    float* dxh = dx + ((long long)r * S + c0) * xrow + (long long)h * P;
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      const int p = j * 8 + 2 * t;
      const float2 va = *reinterpret_cast<const float2*>(Xk + wr * LDP + p);
      const float2 vb =
          *reinterpret_cast<const float2*>(Xk + (wr + 8) * LDP + p);
      xa = fmaf(dxa[j][0], va.x, fmaf(dxa[j][1], va.y, xa));
      xb = fmaf(dxa[j][2], vb.x, fmaf(dxa[j][3], vb.y, xb));
      if (sa < Q)
        *reinterpret_cast<float2*>(dxh + (long long)sa * xrow + p) =
            make_float2(__fmul_rn(dxa[j][0], da), __fmul_rn(dxa[j][1], da));
      if (sb < Q)
        *reinterpret_cast<float2*>(dxh + (long long)sb * xrow + p) =
            make_float2(__fmul_rn(dxa[j][2], db), __fmul_rn(dxa[j][3], db));
    }
    xa = quad_sum(xa);
    xb = quad_sum(xb);
    cs_a = quad_sum(cs_a);
    cs_b = quad_sum(cs_b);
    ca64 = quad_sum(ca64);
    cb64 = quad_sum(cb64);
    T_a = quad_sum(T_a);
    T_b = quad_sum(T_b);
    if (t == 0) {
      const long long o = ((long long)r * H + h) * S + c0;
      const long long od = ((long long)r * S + c0) * H + h;
      if (sa < Q) {
        ddt[od + (long long)sa * H] = xa;
        csum[o + sa] = cs_a;
        csum64[o + sa] = ca64;
        twv[o + sa] = __fmul_rn(T_a, wa);
      }
      if (sb < Q) {
        ddt[od + (long long)sb * H] = xb;
        csum[o + sb] = cs_b;
        csum64[o + sb] = cb64;
        twv[o + sb] = __fmul_rn(T_b, wb);
      }
    }
  }
  // dB of the slice's heads, keys s < Q
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j >= nt) break;
    const int n = j * 8 + 2 * t;
    if (sa < Q)
      *reinterpret_cast<float2*>(out + (long long)sa * brow + n) =
          make_float2(dbacc[j][0], dbacc[j][1]);
    if (sb < Q)
      *reinterpret_cast<float2*>(out + (long long)sb * brow + n) =
          make_float2(dbacc[j][2], dbacc[j][3]);
  }
  TC_FLUSH(tid == 0);
}

// dB and dC from the head slices' partials (ns, R, S, G, N), summed in
// slice order (blockIdx.y: 0 dB, 1 dC).
__global__ void __launch_bounds__(kSumThreads)
ssd_bwd_sum_kernel(const float* __restrict__ parts, float* __restrict__ dB,
                   float* __restrict__ dC, long long n4, int ns) {
  const float4* p = reinterpret_cast<const float4*>(parts) +
                    (long long)blockIdx.y * ns * n4;
  float4* o = reinterpret_cast<float4*>(blockIdx.y == 0 ? dB : dC);
  for (long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;
       i < n4; i += (long long)gridDim.x * kSumThreads) {
    float4 a = p[i];
    for (int k = 1; k < ns; ++k) {
      const float4 b = p[(long long)k * n4 + i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    o[i] = a;
  }
}

// du and ddt of one (row, head, chunk) a warp: dcum_s = ((rows − cols) +
// inter) − T·w, du_s = (Σ dcum + last) − Σ_{t≤s} dcum + dcum_s with the
// offset and the prefix sums in fp64 (last = e^{cum_Q} Σ dh∘h_in + Σ T·w),
// as the simt variant sums them; ddt = Σ_p dxdt·x (left in ddt by the key
// kernel) + du·A. And dA's partial Σ_s du_s·dt_s into dap, from a du
// formed the same way in fp64 throughout: from the fp64 row and column sums
// of DL (rsum64 / csum64), whose fp32 sums would carry ~1e-5 into it (the
// terms of Σ du·dt are ~1e3 times their total at mamba2's widths); its
// lanes' partials are summed in a fixed order. A lane owns a run of Q / 32
// positions. A dead head gets zeros.
__global__ void __launch_bounds__(kDuWarps * 32)
ssd_bwd_du_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ cum,
                  const float* __restrict__ rsum,
                  const float* __restrict__ csum,
                  const float* __restrict__ inter,
                  const float* __restrict__ twv,
                  const double* __restrict__ rsum64,
                  const double* __restrict__ csum64,
                  const double* __restrict__ dhh, const int* __restrict__ ha,
                  float* __restrict__ ddt, float* __restrict__ du,
                  double* __restrict__ dap, int R, int S, int H, int Q,
                  int pslices) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nc = S / Q;
  const long long id = (long long)blockIdx.x * kDuWarps + warp;
  if (id >= (long long)R * H * nc) return;
  const int c = (int)(id % nc), h = (int)((id / nc) % H);
  const int r = (int)(id / ((long long)nc * H));
  const long long od = ((long long)r * S + (long long)c * Q) * H + h;
  const long long oa = ((long long)r * H + h) * nc + c;
  if (!head_live(ha, r, h)) {
    for (int s = lane; s < Q; s += 32) {
      ddt[od + (long long)s * H] = 0.0f;
      du[od + (long long)s * H] = 0.0f;
    }
    if (lane == 0) dap[oa] = 0.0;
    return;
  }
  const long long o = ((long long)r * H + h) * S + (long long)c * Q;
  const int per = (Q + 31) / 32;
  const int b = min(lane * per, Q), e = min(b + per, Q);
  double dsum = 0.0, twsum = 0.0;
  for (int s = b; s < e; ++s) {
    const float d = ((rsum[o + s] - csum[o + s]) + inter[o + s]) - twv[o + s];
    dsum += (double)d;
    twsum += (double)twv[o + s];
  }
  double incl = dsum;                     // prefix sums over the lanes' runs
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, k);
    if (lane >= k) incl += v;
  }
  const double total = __shfl_sync(0xffffffffu, incl, 31);
  double cs = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) cs = 0.0;
#pragma unroll
  for (int k = 16; k > 0; k >>= 1)
    twsum += __shfl_xor_sync(0xffffffffu, twsum, k);
  double dhsum = 0.0;
  if (c < nc - 1)
    for (int k = 0; k < pslices; ++k)
      dhsum += dhh[(((long long)r * H + h) * nc + c) * pslices + k];
  const double last = (double)expf(cum[o + Q - 1]) * dhsum + twsum;
  const float a = A[(long long)r * H + h];
  for (int s = b; s < e; ++s) {
    const float d = ((rsum[o + s] - csum[o + s]) + inter[o + s]) - twv[o + s];
    cs += (double)d;
    const float u = (float)(((total + last) - cs) + (double)d);
    du[od + (long long)s * H] = u;
    ddt[od + (long long)s * H] =
        __fadd_rn(ddt[od + (long long)s * H], __fmul_rn(u, a));
  }
  // dA's partial: the suffix sums again, from the fp64 dcum
  double d64 = 0.0;
  for (int s = b; s < e; ++s)
    d64 += ((rsum64[o + s] - csum64[o + s]) + (double)inter[o + s]) -
           (double)twv[o + s];
  double inc64 = d64;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, inc64, k);
    if (lane >= k) inc64 += v;
  }
  const double total64 = __shfl_sync(0xffffffffu, inc64, 31);
  double cs64 = __shfl_up_sync(0xffffffffu, inc64, 1);
  if (lane == 0) cs64 = 0.0;
  double da = 0.0;
  for (int s = b; s < e; ++s) {
    const double d = ((rsum64[o + s] - csum64[o + s]) +
                      (double)inter[o + s]) - (double)twv[o + s];
    cs64 += d;
    da += (((total64 + last) - cs64) + d) * (double)dt[od + (long long)s * H];
  }
#pragma unroll
  for (int k = 16; k > 0; k >>= 1)
    da += __shfl_xor_sync(0xffffffffu, da, k);
  if (lane == 0) dap[oa] = da;
}

size_t fwd_smem(int P, int N, int Q) {
  return sizeof(float) * ((size_t)(P + 2 * kT) * (N + 1) +
                          (size_t)kT * (P + 1) + (size_t)kT * kLdT + 3 * Q);
}

size_t bwd_smem(int P, int N, int Q) {
  return sizeof(double) * (kThreads + 2 * (size_t)Q) +
         sizeof(float) * ((size_t)(2 * P + 2 * kT) * (N + 1) +
                          (size_t)2 * kT * (P + 1) + (size_t)2 * kT * kLdT +
                          9 * (size_t)Q);
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > (size_t)kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

bool bad_shape(int R, int S, int H, int P, int G, int N, int Q) {
  return R <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || Q <= 0 ||
         S % Q != 0 || N <= 0 || N > kMaxN || (P != 32 && P != 64) ||
         (long long)R * H > 2147483647LL;
}

}  // namespace

// C entry points, bound with ctypes. All pointers are device pointers to
// contiguous fp32 (ha: int32) tensors; the wrapper has checked shapes,
// dtypes and the device. x, y (R, S, H, P); dt (R, S, H); A (R, H); B, C
// (R, S, G, N); ha (R,) or null (every head live); states (R, S/Q, H, P, N)
// or null. Each returns cudaGetLastError() after its launches (0 =
// launched).
//
// ssd_scan_fwd takes the plan of kernels/ssd_scan.py::ssd_plan: variant 0
// (simt) or 1 (mma) and, for mma, the P tile (16 or 32) and two scratch
// buffers: cum (R, H, S) and cb (R, G, S/Q, Qp, Qp) with Qp = Q rounded up
// to 64.
extern "C" int ssd_scan_fwd(const float* x, const float* dt, const float* A,
                            const float* B, const float* C, const int* ha,
                            float* y, float* states, float* cb, float* cum,
                            int R, int S, int H, int P, int G, int N, int Q,
                            int variant, int p_tile, void* stream) {
  if (bad_shape(R, S, H, P, G, N, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (variant == 0) {
    const size_t smem = fwd_smem(P, N, Q);
    if (P == 64) {
      err = prepare(ssd_fwd_kernel<64>, smem);
      if (err) return err;
      ssd_fwd_kernel<64><<<R * H, kThreads, smem, s>>>(
          x, dt, A, B, C, ha, y, states, S, H, G, N, Q);
    } else {
      err = prepare(ssd_fwd_kernel<32>, smem);
      if (err) return err;
      ssd_fwd_kernel<32><<<R * H, kThreads, smem, s>>>(
          x, dt, A, B, C, ha, y, states, S, H, G, N, Q);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != 1 || cb == nullptr || cum == nullptr || N % 8 != 0 ||
      Q > kQMax || (p_tile != 16 && p_tile != 32) || P % p_tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = S / Q, Qp = (Q + kCbT - 1) / kCbT * kCbT;
  const int Qr = (Q + kKT - 1) / kKT * kKT;
  if ((long long)R * G * nc > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  ssd_cum_kernel<<<dim3((H + kCumHeads - 1) / kCumHeads, nc, R), kCumHeads,
                   sizeof(float) * Q * (kCumHeads + 1), s>>>(dt, A, ha, cum,
                                                             S, H, Q);
  const size_t cb_smem = sizeof(float) * 2 * kCbT * (N + 4);
  err = prepare(ssd_cb_kernel, cb_smem);
  if (err) return err;
  const int tq = Qp / kCbT;
  ssd_cb_kernel<<<dim3(tq * (tq + 1) / 2, R * G * nc), kCbThreads, cb_smem,
                  s>>>(B, C, ha, cb, S, H, G, N, Q, Qp);
  const size_t smem = sizeof(float) * mma_fwd_floats(p_tile, N, Qr);
  const long long blocks = (long long)R * H * (P / p_tile);
  if (p_tile == 32) {
    err = prepare(ssd_fwd_mma_kernel<32>, smem);
    if (err) return err;
    ssd_fwd_mma_kernel<32><<<static_cast<unsigned>(blocks), kMmaThreads,
                             smem, s>>>(x, dt, B, C, cb, cum, ha, y, states,
                                        S, H, P, G, N, Q, Qp);
  } else {
    err = prepare(ssd_fwd_mma_kernel<16>, smem);
    if (err) return err;
    ssd_fwd_mma_kernel<16><<<static_cast<unsigned>(blocks), kMmaThreads,
                             smem, s>>>(x, dt, B, C, cb, cum, ha, y, states,
                                        S, H, P, G, N, Q, Qp);
  }
  return static_cast<int>(cudaGetLastError());
}

// ssd_scan_bwd takes the plan of kernels/ssd_scan.py::ssd_bwd_plan:
// variant 0 (simt: dB, dC per head, (R, S, H, N); the scratch pointers may
// be null) or 1 (mma: dB, dC per group, (R, S, G, N)) with its head slice
// and scratch: cum (R, H, S), cb (R, G, S/Q, Qp, Qp), dhs (R, S/Q − 1, H,
// P, N) (null with one chunk), dhh (R, H, S/Q, P/32) fp64, vecs 4 × (R, H,
// S) (the row sums, column sums, inter term and T·w), vecs64 2 × (R, H, S)
// fp64 (the row and column sums again, for dA) and, when a group
// has more than one head slice, parts 2 × (slices, R, S, G, N) (dB's
// partials, then dC's). dx (R, S, H, P); ddt, du (R, S, H); dap (R, H,
// S/Q) fp64, each (row, head, chunk)'s Σ_s du·dt, from du formed in fp64
// with DL's row and column sums taken in fp64 (both variants).
extern "C" int ssd_scan_bwd(const float* x, const float* dt, const float* A,
                            const float* B, const float* C,
                            const float* states, const float* dy,
                            const int* ha, float* dx, float* ddt, float* du,
                            float* dB, float* dC, double* dap, float* cum,
                            float* cb, float* dhs, double* dhh, float* vecs,
                            double* vecs64, float* parts, int R, int S,
                            int H, int P, int G,
                            int N, int Q, int variant, int head_slice,
                            void* stream) {
  if (bad_shape(R, S, H, P, G, N, Q) || dap == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (variant == 0) {
    const size_t smem = bwd_smem(P, N, Q);
    if (P == 64) {
      err = prepare(ssd_bwd_kernel<64>, smem);
      if (err) return err;
      ssd_bwd_kernel<64><<<R * H, kThreads, smem, s>>>(
          x, dt, A, B, C, states, dy, ha, dx, ddt, du, dB, dC, dap, S, H, G,
          N, Q);
    } else {
      err = prepare(ssd_bwd_kernel<32>, smem);
      if (err) return err;
      ssd_bwd_kernel<32><<<R * H, kThreads, smem, s>>>(
          x, dt, A, B, C, states, dy, ha, dx, ddt, du, dB, dC, dap, S, H, G,
          N, Q);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int nc = S / Q, rep = H / G;
  const int Qp = (Q + kCbT - 1) / kCbT * kCbT;
  const int ns = head_slice > 0 ? (rep + head_slice - 1) / head_slice : 0;
  if (variant != 1 || N % 8 != 0 || Q > kQMax || head_slice <= 0 ||
      cum == nullptr || cb == nullptr || dhh == nullptr || vecs == nullptr ||
      vecs64 == nullptr || (nc > 1 && dhs == nullptr) ||
      (ns > 1 && parts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tile_blocks = (long long)(Qp / kBT) * R * nc * G * ns;
  if ((long long)R * G * nc > 65535 || tile_blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  // 1, 2: cum per live head, C·Bᵀ per group
  ssd_bwd_cum_kernel<<<dim3((H + kCumHeads - 1) / kCumHeads, nc, R),
                       kCumHeads, sizeof(float) * Q * (kCumHeads + 1), s>>>(
      dt, A, ha, cum, S, H, Q);
  const size_t cb_smem = sizeof(float) * 2 * kCbT * (N + 4);
  err = prepare(ssd_bwd_cb_kernel, cb_smem);
  if (err) return err;
  const int tq = Qp / kCbT;
  ssd_bwd_cb_kernel<<<dim3(tq * (tq + 1) / 2, R * G * nc), kCbThreads,
                      cb_smem, s>>>(B, C, ha, cb, S, H, G, N, Q, Qp);
  // 3: dh leaving each chunk but the last
  if (nc > 1) {
    const int Qr = (Q + kKT - 1) / kKT * kKT;
    const size_t smem = sizeof(float) * mma_dh_floats(32, N, Qr);
    err = prepare(ssd_bwd_dh_kernel<32>, smem);
    if (err) return err;
    ssd_bwd_dh_kernel<32><<<R * H * (P / 32), kMmaThreads, smem, s>>>(
        dy, C, cum, states, ha, dhs, dhh, S, H, P, G, N, Q);
  }
  // 4, 5: the query and the key tiles
  float* rsum = vecs;
  float* csum = vecs + (long long)R * H * S;
  float* inter = csum + (long long)R * H * S;
  float* twv = inter + (long long)R * H * S;
  double* rsum64 = vecs64;
  double* csum64 = vecs64 + (long long)R * H * S;
  const long long rsgn = (long long)R * S * G * N;
  float* dBp = ns > 1 ? parts : dB;
  float* dCp = ns > 1 ? parts + ns * rsgn : dC;
  const size_t tsmem = sizeof(float) * mma_tile_floats(P, N, Qp);
  const unsigned tb = static_cast<unsigned>(tile_blocks);
  if (P == 64) {
    err = prepare(ssd_bwd_dc_kernel<64>, tsmem);
    if (!err) err = prepare(ssd_bwd_dbx_kernel<64>, tsmem);
    if (err) return err;
    ssd_bwd_dc_kernel<64><<<tb, kBThreads, tsmem, s>>>(
        x, dt, B, C, cb, cum, states, dy, ha, dCp, rsum, rsum64, inter, R, S,
        H, G, N, Q, Qp, head_slice, ns);
    ssd_bwd_dbx_kernel<64><<<tb, kBThreads, tsmem, s>>>(
        x, dt, B, C, cb, cum, dhs, dy, ha, dx, ddt, dBp, csum, csum64, twv, R,
        S, H, G, N, Q, Qp, head_slice, ns);
  } else {
    err = prepare(ssd_bwd_dc_kernel<32>, tsmem);
    if (!err) err = prepare(ssd_bwd_dbx_kernel<32>, tsmem);
    if (err) return err;
    ssd_bwd_dc_kernel<32><<<tb, kBThreads, tsmem, s>>>(
        x, dt, B, C, cb, cum, states, dy, ha, dCp, rsum, rsum64, inter, R, S,
        H, G, N, Q, Qp, head_slice, ns);
    ssd_bwd_dbx_kernel<32><<<tb, kBThreads, tsmem, s>>>(
        x, dt, B, C, cb, cum, dhs, dy, ha, dx, ddt, dBp, csum, csum64, twv, R,
        S, H, G, N, Q, Qp, head_slice, ns);
  }
  // 6: the slices' partials, summed in slice order
  if (ns > 1) {
    const long long n4 = rsgn / 4;
    const long long blocks =
        std::min<long long>((n4 + kSumThreads - 1) / kSumThreads, 65535);
    ssd_bwd_sum_kernel<<<dim3(static_cast<unsigned>(blocks), 2), kSumThreads,
                         0, s>>>(parts, dB, dC, n4, ns);
  }
  // 7: du and ddt
  const long long triples = (long long)R * H * nc;
  ssd_bwd_du_kernel<<<static_cast<unsigned>((triples + kDuWarps - 1) /
                                            kDuWarps),
                      kDuWarps * 32, 0, s>>>(dt, A, cum, rsum, csum, inter,
                                             twv, rsum64, csum64, dhh, ha,
                                             ddt, du, dap, R, S, H, Q,
                                             P / 32);
  return static_cast<int>(cudaGetLastError());
}
