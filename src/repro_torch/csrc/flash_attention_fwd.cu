// flash_attention_fwd — elastic flash attention forward, fp32, for sm_90a.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `_fwd_call` in
// src/repro/kernels/flash_attention.py. Computes, for q (B, Sq, H, D) and
// k, v (B, Sk, KV, D) (GQA: query head h reads KV head h / (H / KV)),
//
//     o = softmax(mask(softcap(scale · q kᵀ))) v,   lse = logsumexp(row)
//
// with causal and sliding-window masks, the optional logit softcap
// (cap · tanh(s / cap)), and a per-batch runtime head prefix h_active (a
// (B,) int32 device tensor): heads at or past it write o = 0 and
// lse = NEG_INF (-2^30) and issue no loads. A row with no valid key writes
// o = 0 and lse = NEG_INF; a row that is fully masked inside a block that
// does contribute collects no exp(0) mass (its probabilities are zeroed
// while its running max is still NEG_INF), as in the reference. K3 / K4
// (csrc/flash_attention_bwd.cu) read this lse unchanged.
//
// What bounds it on the H100: at the training shapes (B = 16 rows of 128
// tokens, 32 or 16 heads) the 4·D operations per valid (query, key) pair
// dominate the bytes — bound by operations, 67 TFLOP/s in fp32 SIMT and
// 495 / 3 TFLOP/s in 3×TF32 on the tensor cores. The serving prefill
// (32 queries and keys a head) moves ~1 MB and does ~40 MFLOP: bound by
// latency, so the block must finish in a few microseconds and no thread
// may run a long dependent chain.
//
// Design (FlashAttention-2 on mma.sync):
//  * One 128-thread block per (batch, query head, 64-query tile); each of
//    its 4 warps owns 16 query rows. The grid's fastest axis is the head,
//    so the query heads of a GQA group are neighbouring blocks and their
//    shared K / V tiles come from L2 (16.8 MB of K / V at the training
//    shape, within the 50 MB L2). A block per (batch, KV head) serving the
//    whole group would load each tile once, but would hold G × 16 × D
//    output rows a warp or G times the warps, and give the prefill G times
//    fewer blocks (8 instead of 32 at granite-3-8b) where latency rules.
//  * K / V tiles of 32 keys come in cp.async 16-byte copies (keys past Sk
//    zero-filled), double-buffered at D ≤ 80 and single-buffered at
//    D = 128 and 256 (`Config`); the 64 × D query tile is copied once.
//    At D = 256 a thread holds 128 floats of O (32 n-tiles × 4), against
//    64 at D = 128, and the block takes a whole SM's shared memory for
//    itself; the compiler's register report (chip_smoke.py phase 2) says
//    whether that spills.
//  * S = Q Kᵀ and O += P V run on mma.sync m16n8k8 in 3×TF32
//    (csrc/mma_tf32.cuh). O's sum runs over every key of the row, so its
//    8-deep steps are summed into a fresh tile and added to fp32
//    accumulators; S's runs over D ≤ 128, at most 48 tensor-core
//    accumulations, and stays in the tensor core (chip_smoke.py's phase 3
//    holds the result to K2's tolerance); at D = 256 each half of D
//    sums in its own accumulator, the two added in fp32. The online softmax lives in
//    registers in the accumulator layout: a thread holds two rows (g and
//    g + 8) of its warp's 16, the row max and sum are reduced across the
//    quad of threads sharing a row.
//  * S's accumulator layout (c0..c3 at rows g, g + 8 and columns 2t, 2t+1)
//    is not the A-fragment layout of m16n8k8 (columns t, t + 4), so P
//    would have to pass through shared memory or shuffles. It does not:
//    both products take their contraction in the order k = 2t in slot t,
//    2t + 1 in slot t + 4 (a sum does not care, as long as the two
//    operands agree), and in that order PV's A fragment is S's
//    accumulator, register for register; V's rows are read to match.
//  * A grid of one query tile per (batch, head) — a prompt of at most 64
//    tokens, bound by latency — sums S in two chains of tensor-core steps
//    (even and odd 8-deep steps) instead of one; with more tiles the extra
//    registers cost more than the shorter chain saves (SPLIT_S, chosen at
//    launch from Sq).
//  * D = 80 (hubert-xlarge; 10 n-tiles of m16n8k8) runs the D ≤ 64 design:
//    K / V double-buffered, 66,560 B of shared memory, S over 10 8-deep
//    steps. Its padded rows stay bank-free: Q and K rows of 88 floats
//    (≡ 24 ≡ −8 mod 32: a half warp's 64-bit words still cover 32 banks),
//    V rows of 84 (≡ 20 mod 32: banks 8t + g). A row is 20 16-byte chunks,
//    so the copies number a row's chunks in slots of a multiple of 8 and
//    no 8-thread phase straddles two rows.
//  * Whole key blocks that cannot contribute are skipped by the predicate
//    of the reference's `attn_block_contributes` (causal: the block starts
//    after the tile's last row; window: it ends before the tile's first
//    row's window); a warp whose 16 rows see no key of a block skips its
//    math; the per-element causal, window and softcap masks are applied to
//    S as before.
#include <cuda_runtime.h>
#include <math.h>

#include "mma_tf32.cuh"
#include "tile_counters.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference NEG_INF
constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;           // query rows per block
constexpr int kThreads = 32 * kWarps;

// Keys per step (BKV) and K / V buffers (NBUF) per head dim. D = 128
// single-buffers K / V: 68 KB of shared memory instead of 103 KB, three
// blocks per SM instead of two, which ran faster on the card at the
// training shape than double buffering (the other blocks hide the loads);
// at D ≤ 64 four or more blocks fit either way and double buffering wins.
// D = 256 (gemma, gemma2) single-buffers too: 134,656 B, one block per SM
// (double buffering would need 202 KB for the same one block).
template <int D>
struct Config {
  static constexpr int kBKV = 32, kNBuf = D >= 128 ? 1 : 2;
};

// Shared rows, padded so that a warp's fragment loads (rows g < 8 at
// k = 2t, 2t + 1; csrc/mma_tf32.cuh) hit distinct banks: 64-bit words of
// the K-contiguous Q and K rows (stride ≡ 8 mod 32), single words of the
// N-contiguous V rows (stride ≡ 4 mod 32).
template <int D>
struct Smem {
  static constexpr int kBK = Config<D>::kBKV, kNBuf = Config<D>::kNBuf;
  static constexpr int kQS = D + 8;  // Q and K rows: D-contiguous, K-major
  static constexpr int kVS = D + 4;  // V rows: the B operand, N-contiguous
  static constexpr int kQ = kBQ * kQS;
  static constexpr int kK = kBK * kQS;
  static constexpr int kV = kBK * kVS;
  static constexpr int kBytes =
      (kQ + kNBuf * (kK + kV)) * static_cast<int>(sizeof(float));
};

// SPLIT_S: S summed in two chains (see below), for grids of one query
// tile per (batch, head) — a short prefill, bound by latency.
template <int D, bool SPLIT_S>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ ha, int Sq,
                 int Sk, int H, int KV, int causal, int window, float cap,
                 float scale) {
  using L = Smem<D>;
  constexpr int kBK = L::kBK, kKVBuf = L::kNBuf;
  constexpr int kNT = D / 8;  // n-tiles of the output row
  // past D = 128, S's two halves of D go to two accumulators, each at most
  // 48 tensor-core accumulations as at D = 128, added in fp32
  constexpr bool kTwoHalves = D > 128;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + L::kQ;
  float* Vs = Ks + kKVBuf * L::kK;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  if (h >= ha[b]) {  // past the head prefix: the block is uniform, no sync
    for (int e = tid; e < kBQ * D; e += kThreads) {
      const int i = e / D, qp = q0 + i;
      if (qp < Sq) o[(((size_t)b * Sq + qp) * H + h) * D + e % D] = 0.0f;
    }
    if (tid < kBQ && q0 + tid < Sq)
      lse[((size_t)b * H + h) * Sq + q0 + tid] = kNegInf;
    return;
  }
  const int kvh = h / (H / KV);

  // the key blocks that can contribute to the tile
  const int nk = (Sk + kBK - 1) / kBK;
  int kb_lo = 0;
  if (window > 0) {
    const int lo = q0 - (window - 1);
    kb_lo = lo > 0 ? lo / kBK : 0;
  }
  const int kb_hi = causal ? min(nk, (q0 + kBQ - 1) / kBK + 1) : nk;

  // a row's 16-byte chunks in slots of a multiple of 8, so that no 8-thread
  // phase of a copy straddles two rows (at D = 80, 20 chunks a row, one
  // that did would write both on 4 common banks); at D a multiple of 32 the
  // slots are the chunks
  constexpr int kC = D / 4, kCP = (kC + 7) / 8 * 8;
  TC_DECL;  // a key block a tile; the Q tile, and K and V a key block
  TC_DMA(1);
  for (int c = tid; c < kBQ * kCP; c += kThreads) {
    const int i = c / kCP, d = (c % kCP) * 4, qp = q0 + i;
    if (kCP != kC && d >= D) continue;
    const float* src = q;
    int bytes = 0;
    if (qp < Sq) {
      src = q + (((size_t)b * Sq + qp) * H + h) * D + d;
      bytes = 16;
    }
    tf32x3::cp_async16(Qs + i * L::kQS + d, src, bytes);
  }
  auto load_kv = [&](int buf, int kb) {
    const int k0 = kb * kBK;
    TC_DMA(2);
    for (int c = tid; c < kBK * kCP; c += kThreads) {
      const int j = c / kCP, d = (c % kCP) * 4, kp = k0 + j;
      if (kCP != kC && d >= D) continue;
      const float* ks = k;
      const float* vs = v;
      int bytes = 0;
      if (kp < Sk) {
        const size_t off = (((size_t)b * Sk + kp) * KV + kvh) * D + d;
        ks = k + off;
        vs = v + off;
        bytes = 16;
      }
      tf32x3::cp_async16(Ks + buf * L::kK + j * L::kQS + d, ks, bytes);
      tf32x3::cp_async16(Vs + buf * L::kV + j * L::kVS + d, vs, bytes);
    }
  };
  if (kKVBuf == 2 && kb_lo < kb_hi) load_kv(0, kb_lo);
  tf32x3::cp_async_commit();

  const int qr0 = q0 + warp * 16;             // the warp's first row
  const int row_a = qr0 + g, row_b = row_a + 8;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int kb = kb_lo, it = 0; kb < kb_hi; ++kb, ++it) {
    const int buf = kKVBuf == 2 ? it & 1 : 0;
    TC_TILES(1);
    if (kKVBuf == 2) {
      if (kb + 1 < kb_hi) load_kv(buf ^ 1, kb + 1);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();  // Q and this block's K / V have landed
    } else {
      load_kv(0, kb);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kb * kBK;
    const bool skip = qr0 >= Sq || (causal && k0 > qr0 + 15) ||
                      (window > 0 && k0 + kBK - 1 < qr0 - (window - 1));
    if (!skip) {  // uniform over the warp
      const float* ks = Ks + buf * L::kK;
      const float* vs = Vs + buf * L::kV;
      // with SPLIT_S two accumulators a tile (even and odd 8-deep steps):
      // half the dependent chain of tensor-core steps, which bounds a short
      // prefill; where many blocks share an SM the registers cost more
      float s[kBK / 8][4], s2[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.0f;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 8) {
        uint32_t ah[4], al[4];
        const float* qa = Qs + (warp * 16 + g) * L::kQS + d0 + 2 * t;
        const float2 q0 = *reinterpret_cast<const float2*>(qa);
        const float2 q1 = *reinterpret_cast<const float2*>(qa + 8 * L::kQS);
        tf32x3::split(q0.x, ah[0], al[0]);
        tf32x3::split(q1.x, ah[1], al[1]);
        tf32x3::split(q0.y, ah[2], al[2]);
        tf32x3::split(q1.y, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          uint32_t bh[2], bl[2];
          const float2 kv = *reinterpret_cast<const float2*>(
              ks + (j * 8 + g) * L::kQS + d0 + 2 * t);
          tf32x3::split(kv.x, bh[0], bl[0]);
          tf32x3::split(kv.y, bh[1], bl[1]);
          tf32x3::mma3(kTwoHalves ? (d0 >= D / 2 ? s2[j] : s[j])
                                  : ((SPLIT_S && (d0 & 8)) ? s2[j] : s[j]),
                       ah, al, bh, bl);
        }
      }
      if (SPLIT_S || kTwoHalves) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];
      }
      // scale, softcap, masks; the row max over the quad sharing a row
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + j * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          float sc = s[j][e] * scale;
          if (cap > 0.0f) sc = cap * tanhf(sc / cap);
          bool ok = kp < Sk;
          if (causal) ok = ok && kp <= row;
          if (window > 0) ok = ok && (row - kp < window);
          s[j][e] = ok ? sc : kNegInf;
        }
        mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float alpha_a = expf(m_a - mn_a), alpha_b = expf(m_b - mn_b);
      // rows with no valid key so far: the running max is still NEG_INF
      // and exp(s - max) would be 1 — zero the probabilities instead
      const bool live_a = mn_a > kNegInf * 0.5f;
      const bool live_b = mn_b > kNegInf * 0.5f;
      // P stays in s: with the k order of csrc/mma_tf32.cuh (k = 2t in
      // slot t, 2t + 1 in slot t + 4) the accumulator (rows g, g + 8;
      // columns 2t, 2t + 1) is exactly PV's A fragment
      float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        s[j][0] = live_a ? expf(s[j][0] - mn_a) : 0.0f;
        s[j][1] = live_a ? expf(s[j][1] - mn_a) : 0.0f;
        s[j][2] = live_b ? expf(s[j][2] - mn_b) : 0.0f;
        s[j][3] = live_b ? expf(s[j][3] - mn_b) : 0.0f;
        ps_a += s[j][0] + s[j][1];
        ps_b += s[j][2] + s[j][3];
      }
      l_a = l_a * alpha_a + ps_a;  // this thread's share of the row sum
      l_b = l_b * alpha_b + ps_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        acc[n][0] *= alpha_a;
        acc[n][1] *= alpha_a;
        acc[n][2] *= alpha_b;
        acc[n][3] *= alpha_b;
      }
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        uint32_t ah[4], al[4];
        tf32x3::split(s[j][0], ah[0], al[0]);  // (g, 2t)
        tf32x3::split(s[j][2], ah[1], al[1]);  // (g + 8, 2t)
        tf32x3::split(s[j][1], ah[2], al[2]);  // (g, 2t + 1)
        tf32x3::split(s[j][3], ah[3], al[3]);  // (g + 8, 2t + 1)
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          uint32_t bh[2], bl[2];
          const float* vr = vs + (j * 8 + 2 * t) * L::kVS + n * 8 + g;
          tf32x3::split(vr[0], bh[0], bl[0]);
          tf32x3::split(vr[L::kVS], bh[1], bl[1]);
          tf32x3::mma3_add(acc[n], ah, al, bh, bl);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  tf32x3::cp_async_wait<0>();
  TC_FLUSH(tid == 0);

  if (qr0 >= Sq) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float lc_a = fmaxf(l_a, 1e-30f), lc_b = fmaxf(l_b, 1e-30f);
  if (row_a < Sq) {
    float* out = o + (((size_t)b * Sq + row_a) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2(acc[n][0] / lc_a, acc[n][1] / lc_a);
    if (t == 0)
      lse[((size_t)b * H + h) * Sq + row_a] =
          l_a > 0.0f ? m_a + logf(lc_a) : kNegInf;
  }
  if (row_b < Sq) {
    float* out = o + (((size_t)b * Sq + row_b) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2(acc[n][2] / lc_b, acc[n][3] / lc_b);
    if (t == 0)
      lse[((size_t)b * H + h) * Sq + row_b] =
          l_b > 0.0f ? m_b + logf(lc_b) : kNegInf;
  }
}

template <int D, bool SPLIT_S>
void launch_kernel(dim3 grid, cudaStream_t s, const float* q,
                   const float* k, const float* v, float* o, float* lse,
                   const int* ha, int Sq, int Sk, int H, int KV, int causal,
                   int window, float cap, float scale) {
  static bool configured = false;  // once per instantiation (one card)
  if (!configured) {
    cudaFuncSetAttribute(flash_fwd_kernel<D, SPLIT_S>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Smem<D>::kBytes);
    configured = true;
  }
  flash_fwd_kernel<D, SPLIT_S><<<grid, kThreads, Smem<D>::kBytes, s>>>(
      q, k, v, o, lse, ha, Sq, Sk, H, KV, causal, window, cap, scale);
}

template <int D>
void launch(dim3 grid, cudaStream_t s, const float* q, const float* k,
            const float* v, float* o, float* lse, const int* ha, int Sq,
            int Sk, int H, int KV, int causal, int window, float cap,
            float scale) {
  if (Sq <= kBQ)
    launch_kernel<D, true>(grid, s, q, k, v, o, lse, ha, Sq, Sk, H, KV,
                           causal, window, cap, scale);
  else
    launch_kernel<D, false>(grid, s, q, k, v, o, lse, ha, Sq, Sk, H, KV,
                            causal, window, cap, scale);
}

}  // namespace

// C entry point, bound with ctypes. All pointers are device pointers to
// 16-byte-aligned contiguous tensors; the wrapper has checked shapes, dtype
// (fp32), contiguity, alignment and device. window <= 0 means no window;
// cap <= 0 means no softcap. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int flash_attention_fwd(const float* q, const float* k,
                                   const float* v, float* o, float* lse,
                                   const int* ha, int B, int Sq, int Sk,
                                   int H, int KV, int D, int causal,
                                   int window, float cap, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || H <= 0) return cudaGetLastError();
  dim3 grid(H, (Sq + kBQ - 1) / kBQ, B);
  switch (D) {
    case 32:
      launch<32>(grid, s, q, k, v, o, lse, ha, Sq, Sk, H, KV, causal, window,
                 cap, scale);
      break;
    case 64:
      launch<64>(grid, s, q, k, v, o, lse, ha, Sq, Sk, H, KV, causal, window,
                 cap, scale);
      break;
    case 80:
      launch<80>(grid, s, q, k, v, o, lse, ha, Sq, Sk, H, KV, causal, window,
                 cap, scale);
      break;
    case 128:
      launch<128>(grid, s, q, k, v, o, lse, ha, Sq, Sk, H, KV, causal,
                  window, cap, scale);
      break;
    case 256:
      launch<256>(grid, s, q, k, v, o, lse, ha, Sq, Sk, H, KV, causal,
                  window, cap, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
