// grouped_matmul — the grouped expert-prefix matmul, fp32, for sm_90a.
//
// Replaces the Pallas TPU kernel `_kernel` / `_grouped_call` in
// src/repro/kernels/grouped_matmul.py, forward and closed VJP (the VJP
// launches this kernel again on transposed operands). For every group g
// (a client in training, a decode slot in serving: the axis the reference
// gets from `vmap`) and every expert e of an (G, E, M, K) input,
//
//     y[g, e] = xs[g, e] @ ws[(g,) e]   if e < g_active[g]   else 0
//
// with the expert prefix g_active read from a (G,) int32 device tensor
// (null: every expert live), so a change of submodel changes tensor values
// and never the launch. ws is (E, K, N), shared by all groups (serving), or
// (G, E, K, N), one per group (training: every client its own experts).
// Accumulation is IEEE fp32 (fmaf, no TF32), each output summed over K in
// order, no atomics: deterministic. Shapes that are not tile multiples are
// masked inside the kernel; nothing is padded on the host.
//
// Layout flags: each (M, K) matrix of x may be stored transposed ((K, M),
// the xsᵀ of the VJP's dws = xsᵀ @ dy) and each (K, N) matrix of w
// transposed ((N, K), the wsᵀ of dxs = dy @ wsᵀ). The group and expert
// axes of both operands sit at any stride (one layer of a client-stacked
// (G, L, E, K, N) parameter is a strided view): the kernel reads them in
// place, so neither pass copies an operand. A tile's loads follow the
// stored layout, so neighbouring threads read neighbouring addresses.
//
// Grid: (N tiles, row tiles, experts × groups). With a per-group w (or a
// transposed x) a block owns one (g, e) pair and rows are that pair's M
// rows. With a shared w a block owns one expert and its rows run over all
// groups' rows of that expert (G·M, each row carrying its group's prefix):
// at decode (G = slots, M = capacity 8) one tile covers every slot, and
// each expert's weights are read once per launch, not once per slot.
//
// What bounds it on the H100. Training (M = 160 capacity rows per client
// and expert, K and N 1024 or 512): 2·M·K·N operations per live (g, e)
// against ~4·K·N weight bytes, about 80 operations per byte — far above
// the fp32 ridge (67 TFLOP/s over 3.35 TB/s, 20 per byte): bound by the
// operations of the live experts. Decode (shared weights, G·M = 16 rows):
// 8 operations per byte, bound by the live experts' weight bytes.
//
// What this simple design does about it: a classic shared-memory SGEMM
// tile (64 × 64 outputs, 16-deep K steps, 4 × 4 outputs per thread, as
// K1's tiled kernel). A tile all of whose rows belong to dead experts
// (e >= g_active[g]) issues no loads and writes zeros; rows of dead
// experts inside a live tile load zeros. Capacity rows that no token
// filled are zero rows and are computed, as in the reference. No load
// pipeline and no tensor cores: that is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kXTrans = 1;     // x stored (.., K, M)
constexpr int kWTrans = 2;     // w stored (.., N, K)
constexpr int kWPerGroup = 4;  // w has a leading group axis

constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);

__global__ void __launch_bounds__(kThreads)
gmm_tiled_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ y, const int* __restrict__ ga, int G,
                 int E, int M, int K, int N, int flags, long long x_gs,
                 long long x_es, long long w_gs, long long w_es) {
  __shared__ float xs[kBK][kBM + 1];  // transposed x tile, padded
  __shared__ float ws[kBK][kBN + 1];
  __shared__ long long xoff_row[kBM];  // where row i's x values start
  __shared__ long long yoff_row[kBM];  // where row i's outputs start
  __shared__ int live_row[kBM];
  const bool grouped = (flags & (kWPerGroup | kXTrans)) != 0;
  const bool x_trans = (flags & kXTrans) != 0;
  const bool w_trans = (flags & kWTrans) != 0;
  // the block's expert, and its group when the block owns one (g, e)
  const int e = grouped ? blockIdx.z % E : blockIdx.z;
  const int g_blk = grouped ? blockIdx.z / E : 0;
  const int rows = grouped ? M : G * M;
  const int r0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  int live = 0;
  if (tid < kBM) {
    const int r = r0 + tid;
    int valid = r < rows;
    int g = g_blk, m = r;
    if (!grouped) { g = r / M; m = r - g * M; }
    live = valid && (ga == nullptr || e < ga[g]);
    live_row[tid] = valid ? (live ? 1 : 0) : -1;  // -1: past the last row
    if (valid) {
      xoff_row[tid] = (long long)g * x_gs + (long long)e * x_es +
                      (long long)m * (x_trans ? 1 : K);
      yoff_row[tid] = (((long long)g * E + e) * M + m) * N;
    }
  }
  // a tile with no live row issues no loads and writes zeros
  const int any_live = __syncthreads_or(live);
  if (!any_live) {
    for (int i = tid; i < kBM * kBN; i += kThreads) {
      const int ri = i / kBN, c = c0 + i % kBN;
      if (live_row[ri] >= 0 && c < N) y[yoff_row[ri] + c] = 0.0f;
    }
    return;
  }
  const float* wb = w + (grouped && (flags & kWPerGroup)
                             ? (long long)g_blk * w_gs : 0) +
                    (long long)e * w_es;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // neighbouring threads take neighbouring addresses of the stored layout
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      int ri, kk;
      if (x_trans) { ri = i % kBM; kk = i / kBM; }
      else { ri = i / kBK; kk = i - ri * kBK; }
      const int k = k0 + kk;
      xs[kk][ri] = (live_row[ri] > 0 && k < K)
                       ? x[xoff_row[ri] + (x_trans ? (long long)k * M : k)]
                       : 0.0f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      int kk, j;
      if (w_trans) { j = i / kBK; kk = i - j * kBK; }
      else { kk = i / kBN; j = i - kk * kBN; }
      const int k = k0 + kk, c = c0 + j;
      ws[kk][j] = (k < K && c < N)
                      ? wb[w_trans ? (long long)c * K + k
                                   : (long long)k * N + c]
                      : 0.0f;
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
    const int ri = ty * kTM + i;
    const int lr = live_row[ri];
    if (lr < 0) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = c0 + tx + j * (kBN / kTN);
      if (c < N) y[yoff_row[ri] + c] = lr > 0 ? acc[i][j] : 0.0f;
    }
  }
}

}  // namespace

// C entry point, bound with ctypes. All pointers are device pointers; the
// wrapper has checked shapes, dtype (fp32) and device. x is (G, E, M, K)
// (each (M, K) matrix row-major, or stored (K, M) with kXTrans), w is
// (E, K, N) or (G, E, K, N) with kWPerGroup (each (K, N) matrix row-major,
// or stored (N, K) with kWTrans); x_gs / x_es / w_gs / w_es are the
// elements between two groups' and two experts' matrices. y is (G, E, M,
// N), contiguous. A null ga means every expert is live in every group.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int gmm_forward(const float* x, const float* w, float* y,
                           const int* ga, int G, int E, int M, int K, int N,
                           int flags, long long x_gs, long long x_es,
                           long long w_gs, long long w_es, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || E <= 0 || M <= 0 || N <= 0)
    return static_cast<int>(cudaGetLastError());
  const bool grouped = (flags & (kWPerGroup | kXTrans)) != 0;
  const long long rows = grouped ? M : (long long)G * M;
  const long long zs = grouped ? (long long)G * E : E;
  if (zs > 65535 || (rows + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid((N + kBN - 1) / kBN, static_cast<unsigned>((rows + kBM - 1) / kBM),
            static_cast<unsigned>(zs));
  gmm_tiled_kernel<<<grid, kThreads, 0, s>>>(x, w, y, ga, G, E, M, K, N,
                                             flags, x_gs, x_es, w_gs, w_es);
  return static_cast<int>(cudaGetLastError());
}
