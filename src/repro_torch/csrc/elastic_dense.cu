// elastic_dense — the tile-skipping elastic dense layer, fp32, for sm_90a.
//
// Replaces the Pallas TPU kernel `_edense_kernel` / `_edense_call` in
// src/repro/kernels/elastic_matmul.py (forward only; the closed VJP comes
// with the training slice). Computes, for every group g of a (G, M, K) input
//
//     y[g] = R_m · C_n · act((x[g] · P_k) @ w + b)
//
// with per-group runtime prefixes k_active[g] (contraction), n_active[g]
// (output columns) and m_active[g] (rows), read from (G,) int32 device
// tensors, so a change of submodel changes tensor values and never the
// launch. w (K, N) and bias (N,) are shared by all groups. act is 0 none,
// 1 silu, 2 gelu (tanh approximation), 3 relu. Accumulation is IEEE fp32
// (fmaf, no TF32). Shapes that are not tile multiples are masked inside the
// kernel; nothing is padded on the host.
//
// The (G, M) axes are flattened to R = G·M rows, each carrying its group's
// prefixes, so the serving path's two uses share one entry point: decode
// (G = slots, M = 1: every slot a different submodel) and prefill
// (G = 1, M = prompt length).
//
// What bounds it on the H100: at decode shapes the layer is a GEMV over a
// shared weight — 2·R·K·N operations against K·N·4 weight bytes, about R/2
// operations per byte for R ≤ 8 rows, far below the card's fp32 ridge
// (67 TFLOP/s over 3.35 TB/s, 20 operations per byte). The least time is
// the active weight bytes over 3.35 TB/s. At prefill (R = prompt length)
// the product has R/2 operations per byte, still bytes-bound for R < 40.
//
// What this simple design does about it:
//  * rows kernel (R ≤ 8, decode): every weight element is read from device
//    memory exactly once per launch, for all rows together. A block owns 32
//    output columns; its 8 warps split the contraction, each warp keeping 8
//    independent 128-byte weight loads in flight, and reduce in a fixed
//    order through shared memory. Output column blocks with no live row,
//    and K past the largest live k prefix, issue no weight loads at all — a
//    narrower submodel moves fewer bytes.
//  * tiled kernel (R > 8, prefill): a classic shared-memory SGEMM tile
//    (64 × 64 outputs, 16-deep K steps, 4 × 4 outputs per thread). The K
//    loop of a tile stops at the largest k prefix of its live rows, and
//    rows past their own prefix load zeros.
//  * split-K: a grid of output tiles alone is too small to keep enough
//    loads in flight (the 4096-wide down projection has 128 column blocks
//    for 132 SMs), so `edense_plan` splits the contraction into chunks
//    until there are about eight blocks per SM. Each chunk writes its raw
//    partial sums to a (splits, R, N) scratch buffer and a second kernel
//    adds them in a fixed order and applies bias, activation and masks —
//    deterministic, no atomics.
// Neither kernel overlaps its loads with its math (no cp.async or TMA
// pipeline) and neither uses the tensor cores: that is later work.
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

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

// Contraction end of row r for an output tile starting at column c0: 0 when
// the row has no live output in the tile (past its m prefix, or the tile past
// its n prefix), else its k prefix clamped to [0, K].
__device__ __forceinline__ int row_kend(int r, int R, int M, int K, int N,
                                        int c0, const int* ka, const int* na,
                                        const int* ma) {
  if (r >= R) return 0;
  int g = r / M, m = r - g * M;
  if (m >= prefix(ma, g, M) || c0 >= prefix(na, g, N)) return 0;
  return min(max(prefix(ka, g, K), 0), K);
}

__device__ __forceinline__ float epilogue(float acc, int r, int c, int M,
                                          int N, const float* bias,
                                          const int* na, const int* ma,
                                          int act) {
  int g = r / M, m = r - g * M;
  if (m >= prefix(ma, g, M) || c >= prefix(na, g, N)) return 0.0f;
  if (bias != nullptr) acc += bias[c];
  return apply_act(acc, act);
}

// Where a block's sum for (r, c) goes: straight through the epilogue into y
// when the contraction is not split, else raw into its chunk's partials.
__device__ __forceinline__ void store(float acc, int r, int c, int M, int N,
                                      int R, const float* bias,
                                      const int* na, const int* ma, int act,
                                      float* y, float* partial) {
  if (partial == nullptr)
    y[(size_t)r * N + c] = epilogue(acc, r, c, M, N, bias, na, ma, act);
  else
    partial[((size_t)blockIdx.z * R + r) * N + c] = acc;
}

// ---------------------------------------------------------------------------
// rows kernel: R <= 8 rows, 32 output columns per block, 8 warps split K
// ---------------------------------------------------------------------------
constexpr int kRows = 8;    // max rows; also the number of warps
constexpr int kRowsBN = 32;
constexpr int kUnroll = 8;  // weight loads in flight per warp
// Residency floor: caps registers at 64 a thread so at least 4 blocks
// (32 warps, 256 loads of 128 bytes) stay in flight per SM; unbounded,
// the unrolled loads once took 152 registers and left one block per SM.
constexpr int kRowsMinBlocks = 4;

__global__ void __launch_bounds__(kRows * 32, kRowsMinBlocks)
edense_rows_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ y,
                   float* __restrict__ partial, const int* __restrict__ ka,
                   const int* __restrict__ na, const int* __restrict__ ma,
                   int G, int M, int K, int N, int kchunk, int act) {
  __shared__ int kend_row[kRows];
  __shared__ float red[kRows][kRows][kRowsBN];
  const int R = G * M;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kRowsBN, c = c0 + lane;
  if (threadIdx.x < kRows)
    kend_row[threadIdx.x] = row_kend(threadIdx.x, R, M, K, N, c0, ka, na,
                                     ma);
  __syncthreads();
  int kend = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) kend = max(kend, kend_row[r]);
  const int k_lo = blockIdx.z * kchunk;
  const int k_hi = min(kend, k_lo + kchunk);
  // Lane l fetches x[r][kb + l % 8] of row r = l / 8 (first load) and
  // r + 4 (second): each step's x values arrive in two coalesced loads
  // issued beside the weight loads, then travel by shuffle. A row past its
  // own k prefix reads 0, which adds nothing.
  static_assert(kRows == 2 * (32 / kUnroll), "two x loads cover the rows");
  const int xu = lane % kUnroll, xr = lane / kUnroll;
  const int xend_a = min(kend_row[xr], k_hi);
  const int xend_b = min(kend_row[xr + kRows / 2], k_hi);

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  const bool col_ok = c < N;
  for (int kb = k_lo + warp * kUnroll; kb < k_hi; kb += kRows * kUnroll) {
    float wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int k = kb + u;
      wv[u] = (col_ok && k < k_hi) ? __ldg(&w[(size_t)k * N + c]) : 0.0f;
    }
    const int kx = kb + xu;
    const float xa =
        (kx < xend_a) ? __ldg(&x[(size_t)xr * K + kx]) : 0.0f;
    const float xb = (kx < xend_b)
        ? __ldg(&x[(size_t)(xr + kRows / 2) * K + kx]) : 0.0f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < R) {  // uniform over the warp
          const float xv = __shfl_sync(0xffffffffu, r < kRows / 2 ? xa : xb,
                                       (r % (kRows / 2)) * kUnroll + u);
          acc[r] = fmaf(xv, wv[u], acc[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
  const int r = warp;  // warp r reduces row r in a fixed order
  if (r < R && col_ok) {
    float s = 0.0f;
#pragma unroll
    for (int v = 0; v < kRows; ++v) s += red[v][r][lane];
    store(s, r, c, M, N, R, bias, na, ma, act, y, partial);
  }
}

// ---------------------------------------------------------------------------
// tiled kernel: R > 8 rows, 64 x 64 output tile, 4 x 4 outputs per thread
// ---------------------------------------------------------------------------
constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
constexpr int kTiledThreads = (kBM / kTM) * (kBN / kTN);

__global__ void __launch_bounds__(kTiledThreads)
edense_tiled_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y,
                    float* __restrict__ partial, const int* __restrict__ ka,
                    const int* __restrict__ na, const int* __restrict__ ma,
                    int G, int M, int K, int N, int kchunk, int act) {
  __shared__ float xs[kBK][kBM + 1];  // transposed x tile, padded
  __shared__ float ws[kBK][kBN];
  __shared__ int kend_row[kBM];
  __shared__ int kend_tile;
  const int R = G * M;
  const int r0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  if (tid == 0) kend_tile = 0;
  __syncthreads();
  if (tid < kBM) {
    int e = row_kend(r0 + tid, R, M, K, N, c0, ka, na, ma);
    kend_row[tid] = e;
    atomicMax(&kend_tile, e);
  }
  __syncthreads();
  const int k_lo = blockIdx.z * kchunk;
  const int k_hi = min(kend_tile, k_lo + kchunk);
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kTiledThreads) {
      int i = e / kBK, kk = e - i * kBK, k = k0 + kk;
      xs[kk][i] = (k < kend_row[i] && k < k_hi)
                      ? x[(size_t)(r0 + i) * K + k] : 0.0f;
    }
    for (int e = tid; e < kBK * kBN; e += kTiledThreads) {
      int kk = e / kBN, j = e - kk * kBN, k = k0 + kk, cc = c0 + j;
      ws[kk][j] = (k < k_hi && cc < N) ? w[(size_t)k * N + cc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[kk][tx + j * (kBN / kTN)];
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
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      int cc = c0 + tx + j * (kBN / kTN);
      if (cc < N) store(acc[i][j], r, cc, M, N, R, bias, na, ma, act, y,
                        partial);
    }
  }
}

// ---------------------------------------------------------------------------
// split-K reduction: fixed-order sum of the chunks' partials + epilogue
// ---------------------------------------------------------------------------
__global__ void edense_reduce_kernel(const float* __restrict__ partial,
                                     int splits,
                                     const float* __restrict__ bias,
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
  y[i] = epilogue(s, r, c, M, N, bias, na, ma, act);
}

constexpr int kBlocksPerSM = 8;  // 256-thread blocks that fill an SM
constexpr int kChunkAlign = kRows * kUnroll;  // multiple of kBK too

int output_blocks(int R, int N) {
  if (R <= kRows) return (N + kRowsBN - 1) / kRowsBN;
  return ((N + kBN - 1) / kBN) * ((R + kBM - 1) / kBM);
}

}  // namespace

// How a launch splits its contraction, from the shapes alone (never from
// the prefixes, so a change of submodel never changes the plan): returns
// the number of chunks and writes the chunk length to *kchunk. The caller
// allocates a (splits, G·M, N) fp32 scratch buffer when splits > 1.
extern "C" int edense_plan(int G, int M, int K, int N, int sms,
                           int* kchunk) {
  const int R = G * M;
  int splits = 1;
  if (R > 0 && N > 0 && K > kChunkAlign) {
    const int want = kBlocksPerSM * sms;
    const int blocks = output_blocks(R, N);
    splits = (want + blocks - 1) / blocks;
    splits = std::max(1, std::min(splits, K / kChunkAlign));
  }
  int chunk = (K + splits - 1) / splits;
  chunk = std::max(kChunkAlign, (chunk + kChunkAlign - 1) / kChunkAlign *
                               kChunkAlign);
  *kchunk = chunk;
  return std::max(1, (K + chunk - 1) / chunk);
}

// C entry point, bound with ctypes. All pointers are device pointers; the
// wrapper has checked shapes, dtype (fp32), contiguity and device, and
// passes the plan of `edense_plan` (partial may be null when splits == 1).
// A null ka / na / ma means the full extent for every group.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int edense_forward(const float* x, const float* w,
                              const float* bias, float* y, float* partial,
                              const int* ka, const int* na, const int* ma,
                              int G, int M, int K, int N, int splits,
                              int kchunk, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = G * M;
  if (R <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (splits < 1 || (splits > 1 && partial == nullptr) || kchunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  float* part = splits > 1 ? partial : nullptr;
  if (R <= kRows) {
    dim3 grid((N + kRowsBN - 1) / kRowsBN, 1, splits);
    edense_rows_kernel<<<grid, kRows * 32, 0, s>>>(
        x, w, bias, y, part, ka, na, ma, G, M, K, N, kchunk, act);
  } else {
    dim3 grid((N + kBN - 1) / kBN, (R + kBM - 1) / kBM, splits);
    edense_tiled_kernel<<<grid, kTiledThreads, 0, s>>>(
        x, w, bias, y, part, ka, na, ma, G, M, K, N, kchunk, act);
  }
  if (splits > 1) {
    const size_t total = (size_t)R * N;
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((total + threads - 1) /
                                                  threads);
    edense_reduce_kernel<<<blocks, threads, 0, s>>>(part, splits, bias, y,
                                                    na, ma, R, M, N, act);
  }
  return static_cast<int>(cudaGetLastError());
}
