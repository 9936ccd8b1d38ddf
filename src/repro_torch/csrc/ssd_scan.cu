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
// K9 walks the chunks in reverse, carrying the state cotangent dh, and
// emits dx, ddt, du (the cotangent of u = dt·A) and dB / dC per head; the
// wrapper reduces du to dA and sums dB / dC over each group's heads in
// torch (deterministic: no atomics across heads). Each chunk reads the
// state it entered with from the forward's `states` output (K8 rerun with
// states, flash style: no O(S·P) activations are kept).
//
// Elasticity: a (R,) int32 head prefix h_active (null: every head). A
// block whose head is at or past its row's prefix issues no loads and
// writes zeros to all of its outputs.
//
// Design of K9 (and of K8's `simt` variant, the first design). The TPU
// kernels carry the state in VMEM across a sequential grid axis over
// chunks; here one block owns one (row, head) and loops over the chunks
// itself, the state (K8) or its cotangent (K9) in shared memory (P·N·4 =
// 32 KB at P = 64, N = 128). A chunk's Q×Q decay-masked score block (256 KB
// at Q = 256) does not fit shared memory, so it is tiled: query tiles of 64
// rows, and for each only the key tiles s ≤ t; a score tile C_t·B_sᵀ is
// summed over N, scaled by e^{cum_t − cum_s} below the diagonal and zeroed
// above it — exp is never evaluated on the upper triangle, where the
// reference's dense path overflows. Every query tile reads the state the
// chunk entered with; the state is updated only after all of them. B and C
// are read at group width (head h reads group h / (H / G)); nothing is
// repeated over heads. K9 runs two passes over the tile pairs — by query
// tile (dC and the row sums of dG∘L∘CB) and by key tile (dx, dB and the
// column sums), recomputing the score tiles rather than keeping
// accumulators for a whole chunk — then the state terms and the suffix sum
// that turns the cum cotangent into du. These use scalar FMAs from shared
// memory on 4×4 register tiles; a block takes ~135 KB (K8) / ~215 KB (K9)
// of shared memory, so one block runs per SM.
//
// cum is accumulated in index order in fp64 and rounded to fp32 once: the
// plain versions (torch.cumsum of the fp32 products in float64) give the
// same bits whatever order their sum runs in. The SIMT kernels' other sums
// are IEEE fp32 (fmaf) in a fixed order; no atomics, deterministic.
//
// What bounds it on the H100. Per live (row, head, chunk), with the causal
// triangle T = Q(Q+1)/2: K8 2T·P + 4QPN operations, plus 2T·N per (row,
// group, chunk) for C·Bᵀ; K9 2T(3N+2P) + 10QPN; at the training slice (16
// rows, 80 heads, prefixes 80/40/60/20, 2 chunks of 256, P = 64, N = 128)
// about 20 and 87.5 GFLOP against 0.22 and 1.05 GB of traffic (K9's
// per-head dB / dC are 335 MB each): bound by the operations (fp32 outside
// the tensor cores peaks at 67 TFLOP/s).
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
// Shapes the mma variant does not take (N not a multiple of 8 or above
// 128, Q above 256, operands not 16-byte aligned) run the `simt` variant.
#include <cuda_runtime.h>
#include <math.h>

#include "mma_tf32.cuh"

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

  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
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
      float acc[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.0f;
      for (int k0 = 0; k0 <= q0; k0 += kT) {
        load_rows(Bs, ldn, Bc, q.brow, k0, Q, N, nullptr, nullptr);
        load_rows(Xs, kLdX, xc, q.xrow, k0, Q, P, dts, nullptr);
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
// in fp64 (as chunk_cumsum), written out through shared memory so that
// each head's Q values leave as one contiguous run.
__global__ void __launch_bounds__(kCumHeads)
ssd_cum_kernel(const float* __restrict__ dt, const float* __restrict__ A,
               const int* __restrict__ ha, float* __restrict__ cum, int S,
               int H, int Q) {
  extern __shared__ float tile[];   // [Q][kCumHeads + 1]
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

// cb[r, g, c, t, s] = C_t·B_s over N for one 64 × 64 tile on or below the
// diagonal of chunk c (grid x: the tiles (ti, si), si ≤ ti; grid y: (r, g,
// c)). Both operands are K-contiguous: native k order, rows padded to
// N + 4 (words 4g + t of a fragment load: distinct banks).
__global__ void __launch_bounds__(kCbThreads)
ssd_cb_kernel(const float* __restrict__ B, const float* __restrict__ C,
              const int* __restrict__ ha, float* __restrict__ cb, int S,
              int H, int G, int N, int Q, int Qp) {
  extern __shared__ __align__(16) float smem[];
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

  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    const float* xc = xb + (long long)c0 * xrow;
    const float* Bc = Bb + (long long)c0 * brow;
    const float* Cc = Cb + (long long)c0 * brow;
    // one ring stage: keys [kt·32, kt·32 + 32) of x (PT columns) and B
    auto load_stage = [&](int kt) {
      float* xs = ring + (kt % kStages) * stage_floats;
      float* bs = xs + kKT * LDX;
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
               float* __restrict__ dC, int S, int H, int G, int N, int Q) {
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
    return;
  }
  double* red = reinterpret_cast<double*>(smem);  // [kThreads]
  float* Hin = smem + 2 * kThreads;  // [P][ldn] state entering the chunk
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

  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * Q;
    const float* xc = xb + (long long)c0 * q.xrow;
    const float* dyc = dyb + (long long)c0 * q.xrow;
    const float* Bc = Bb + (long long)c0 * q.brow;
    const float* Cc = Cb + (long long)c0 * q.brow;
    for (int i = tid; i < Q; i += kThreads) {
      dts[i] = dtb[(long long)(c0 + i) * H];
      rsum[i] = 0.0f;
      csum[i] = 0.0f;
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
      float dcv[4][kNB];                 // t = ty+16i, n = tx+16j
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNB; ++j) dcv[i][j] = 0.0f;
      for (int k0 = 0; k0 <= q0; k0 += kT) {
        load_rows(Bs, ldn, Bc, q.brow, k0, Q, N, nullptr, nullptr);
        load_rows(Xs, kLdX, xc, q.xrow, k0, Q, P, dts, nullptr);
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
          for (int s = 0; s < rows; ++s) acc += T2[tid * kLdT + s];
          rsum[q0 + tid] += acc;
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
          for (int t = 0; t < rows; ++t) acc += T1[t * kLdT + tid];
          csum[k0 + tid] += acc;
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
    // would be multiplied by Σ_s dt_s.
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
}

size_t fwd_smem(int P, int N, int Q) {
  return sizeof(float) * ((size_t)(P + 2 * kT) * (N + 1) +
                          (size_t)kT * (P + 1) + (size_t)kT * kLdT + 3 * Q);
}

size_t bwd_smem(int P, int N, int Q) {
  return sizeof(double) * kThreads +
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

// dx (R, S, H, P); ddt, du (R, S, H); dB, dC (R, S, H, N) per head.
extern "C" int ssd_scan_bwd(const float* x, const float* dt, const float* A,
                            const float* B, const float* C,
                            const float* states, const float* dy,
                            const int* ha, float* dx, float* ddt, float* du,
                            float* dB, float* dC, int R, int S, int H, int P,
                            int G, int N, int Q, void* stream) {
  if (bad_shape(R, S, H, P, G, N, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem(P, N, Q);
  int err;
  if (P == 64) {
    err = prepare(ssd_bwd_kernel<64>, smem);
    if (err) return err;
    ssd_bwd_kernel<64><<<R * H, kThreads, smem, s>>>(
        x, dt, A, B, C, states, dy, ha, dx, ddt, du, dB, dC, S, H, G, N, Q);
  } else {
    err = prepare(ssd_bwd_kernel<32>, smem);
    if (err) return err;
    ssd_bwd_kernel<32><<<R * H, kThreads, smem, s>>>(
        x, dt, A, B, C, states, dy, ha, dx, ddt, du, dB, dC, S, H, G, N, Q);
  }
  return static_cast<int>(cudaGetLastError());
}
