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
// while its running max is still NEG_INF), as in the reference.
//
// Blocking: one block per (batch, head, tile of 16 query rows); the loop
// over 32-key blocks lives inside it, with the online-softmax state (running
// max, sum and the output row) in registers. Key blocks that cannot
// contribute are skipped by the predicate of the reference's
// `attn_block_contributes` (causal: the block starts after the tile's last
// row; window: it ends before the tile's first row's window). Eight threads
// share a query row: each scores 4 of the 32 keys and owns D/8 output
// columns.
//
// What bounds it on the H100: prefill at the slice's shapes (Sq = Sk =
// prompt length ≤ a few hundred) moves q, k, v and o once — about a
// megabyte — and does 4·D operations per valid (query, key) pair; both
// bounds are a microsecond or less, so launch latency and the serial
// per-block loop dominate. This simple design keeps every tile in shared
// memory and never touches the tensor cores; a wgmma/TMA pipeline is the
// work of a later change, when prompts grow long enough to matter.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference NEG_INF
constexpr int kBQ = 16;                    // query rows per block
constexpr int kTPR = 8;                    // threads per query row
constexpr int kBK = 32;                    // keys per step
constexpr int kThreads = kBQ * kTPR;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ ha, int Sq,
                 int Sk, int H, int KV, int causal, int window, float cap,
                 float scale) {
  constexpr int DPT = D / kTPR;    // output columns per thread
  constexpr int KPT = kBK / kTPR;  // keys scored per thread per step
  __shared__ float qs[kBQ][D + 1];
  __shared__ float ks[kBK][D + 1];
  __shared__ float vs[kBK][D];
  __shared__ float ps[kBQ][kBK + 1];

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid / kTPR, t = tid % kTPR;
  const int q0 = blockIdx.x * kBQ, qpos = q0 + row;
  const bool q_ok = qpos < Sq;
  float* o_row = o + (((size_t)b * Sq + qpos) * H + h) * D;
  float* lse_at = lse + ((size_t)b * H + h) * Sq + qpos;

  if (h >= ha[b]) {  // past the head prefix: the block is uniform, no sync
    if (q_ok) {
#pragma unroll
      for (int i = 0; i < DPT; ++i) o_row[t + i * kTPR] = 0.0f;
      if (t == 0) *lse_at = kNegInf;
    }
    return;
  }

  const int kvh = h / (H / KV);
  for (int e = tid; e < kBQ * D; e += kThreads) {
    int i = e / D, d = e - i * D, qp = q0 + i;
    qs[i][d] = (qp < Sq) ? q[(((size_t)b * Sq + qp) * H + h) * D + d] : 0.0f;
  }

  float m = kNegInf, l = 0.0f, acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.0f;

  const int nk = (Sk + kBK - 1) / kBK;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBK;
    // whole-block skipping (uniform over the block)
    if (causal && k0 > q0 + kBQ - 1) break;
    if (window > 0 && k0 + kBK - 1 < q0 - (window - 1)) continue;
    __syncthreads();  // the previous step's readers of ks / vs are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      int j = e / D, d = e - j * D, kp = k0 + j;
      size_t off = (((size_t)b * Sk + kp) * KV + kvh) * D + d;
      bool ok = kp < Sk;
      ks[j][d] = ok ? k[off] : 0.0f;
      vs[j][d] = ok ? v[off] : 0.0f;
    }
    __syncthreads();

    float s[KPT], mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = t + jj * kTPR, kp = k0 + j;
      float dot = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qs[row][d], ks[j][d], dot);
      float sc = dot * scale;
      if (cap > 0.0f) sc = cap * tanhf(sc / cap);
      bool ok = kp < Sk;
      if (causal) ok = ok && kp <= qpos;
      if (window > 0) ok = ok && (qpos - kp < window);
      s[jj] = ok ? sc : kNegInf;
      mx = fmaxf(mx, s[jj]);
    }
#pragma unroll
    for (int off = kTPR / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    // rows with no valid key so far: m_new is still NEG_INF and
    // exp(s - m_new) would be 1 — zero the probabilities instead
    const bool live = m_new > kNegInf * 0.5f;
    float psum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      float p = live ? expf(s[jj] - m_new) : 0.0f;
      ps[row][t + jj * kTPR] = p;
      psum += p;
    }
#pragma unroll
    for (int off = kTPR / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's kTPR threads share one warp
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int j = 0; j < kBK; ++j) {
      const float p = ps[row][j];
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(p, vs[j][t + i * kTPR], acc[i]);
    }
  }

  if (q_ok) {
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) o_row[t + i * kTPR] = acc[i] / lc;
    if (t == 0) *lse_at = (l > 0.0f) ? m + logf(lc) : kNegInf;
  }
}

}  // namespace

// C entry point, bound with ctypes. All pointers are device pointers; the
// wrapper has checked shapes, dtype (fp32), contiguity and device. window
// <= 0 means no window; cap <= 0 means no softcap. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_fwd(const float* q, const float* k,
                                   const float* v, float* o, float* lse,
                                   const int* ha, int B, int Sq, int Sk,
                                   int H, int KV, int D, int causal,
                                   int window, float cap, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || H <= 0) return cudaGetLastError();
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  switch (D) {
    case 32:
      flash_fwd_kernel<32><<<grid, kThreads, 0, s>>>(
          q, k, v, o, lse, ha, Sq, Sk, H, KV, causal, window, cap, scale);
      break;
    case 64:
      flash_fwd_kernel<64><<<grid, kThreads, 0, s>>>(
          q, k, v, o, lse, ha, Sq, Sk, H, KV, causal, window, cap, scale);
      break;
    case 128:
      flash_fwd_kernel<128><<<grid, kThreads, 0, s>>>(
          q, k, v, o, lse, ha, Sq, Sk, H, KV, causal, window, cap, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
