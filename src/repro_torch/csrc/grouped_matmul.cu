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
// Shapes that are not tile multiples are masked inside the kernel; nothing
// is padded on the host. No atomics: every output is summed in a fixed
// order, deterministic.
//
// Layout flags: each (M, K) matrix of x may be stored transposed ((K, M),
// the xsᵀ of the VJP's dws = xsᵀ @ dy) and each (K, N) matrix of w
// transposed ((N, K), the wsᵀ of dxs = dy @ wsᵀ). The group and expert
// axes of both operands sit at any stride (one layer of a client-stacked
// (G, L, E, K, N) parameter is a strided view): the kernel reads them in
// place, so neither pass copies an operand.
//
// Rows. With a per-group w (or a transposed x) a block owns one (g, e) pair
// and its rows are that pair's M rows (grid z = G·E). With a shared w a
// block owns one expert and its rows run over all groups' rows of that
// expert (G·M, each row carrying its group's prefix; grid z = E): at decode
// (G = slots, M = capacity 8) one tile covers every slot, and each expert's
// weights are read once per launch, not once per slot. A block all of whose
// rows belong to dead experts (e >= g_active[g]) issues no loads and writes
// zeros; dead rows inside a live tile load zeros. Capacity rows that no
// token filled are zero rows and are computed, as in the reference.
//
// What bounds it on the H100. Training (M = 160 capacity rows per client
// and expert, K and N 1024 or 512, or the 160-deep contraction of dws):
// 2·M·K·N operations per live (g, e) against ~4·K·N weight bytes, about 80
// operations per byte — far above the ridge: bound by the operations of the
// live experts. fp32 outside the tensor cores peaks at 67 TFLOP/s, so the
// products run on the tensor cores in 3×TF32 (csrc/mma_tf32.cuh: three
// TF32 products per fp32 product, each 8-deep step promoted into fp32
// adds), a ceiling of 495 / 3 ≈ 165 TFLOP/s at about fp32 accuracy. Decode
// (shared weights, G·M = 16 rows): 8 operations per byte, bound by the live
// experts' weight bytes over 3.35 TB/s.
//
// Three variants, chosen by the launch plan (kernels/grouped_matmul.py::
// _plan) from the shapes, the layout flags and the operands' 16-byte
// alignment — never from the prefixes:
//  * tile (`gmm_mma_kernel`, BM = 80 or 128): mma.sync m16n8k8 in 3×TF32
//    on K1's ring-stage tile (tf32x3::stage_mma), fed by a 3-stage
//    cp.async ring of 16-byte copies, two blocks per SM. The plan takes
//    the row tile whose last tile is fullest: 80 × 128 outputs per
//    128-thread block (4 warps of 80 × 32, 5 × 4 m16n8 tiles each; ~30 KB
//    a stage) for the 160 capacity rows of the forward and dxs — exactly
//    two row tiles, where a 128-row tile would leave its second one 75 %
//    empty — and K1's 128 × 128 tile (8 warps of 64 × 32; ~34 KB a stage)
//    for dws, whose rows are the model's 1024 or 512 and whose contraction
//    is only the 160 capacity rows: the 256-thread block spreads each
//    block's prologue and epilogue over twice the warps (faster on the card
//    than the 80-row tile there, slower for the forward). All three
//    layouts of the training path are read in place: the forward (x
//    K-contiguous, w N-contiguous), dxs (wsᵀ, K-contiguous) and dws (xsᵀ,
//    rows-contiguous).
//  * stream (the same kernel with BM = 16, 32 or 64): at most 64 rows a
//    block, x K-contiguous and w N-contiguous — the serving path's decode
//    and prefill on shared weights, bound by the weight stream. 16-byte
//    copies along N in 512-byte row segments (BN = 128), a 3-stage ring,
//    three blocks per SM up to 32 rows, and a split of the contraction that
//    fills every resident slot of the card in one wave (K1's skinny plan).
//  * simt (`gmm_tiled_kernel`): the first design, a 64 × 64 SIMT tile with
//    16-deep K steps and fmaf, kept for operands whose rows are not 16-byte
//    aligned (cp.async cannot copy them) and for x and w both transposed.
//
// Split-K: each contraction chunk writes its raw sums (zeros for dead
// experts) to a (splits, G, E, M, N) scratch buffer and a second kernel
// adds them in a fixed order.
#include <cuda_runtime.h>

#include "mma_tf32.cuh"
#include "tile_counters.cuh"

namespace {

constexpr int kXTrans = 1;     // x stored (.., K, M)
constexpr int kWTrans = 2;     // w stored (.., N, K)
constexpr int kWPerGroup = 4;  // w has a leading group axis

// Variants of `gmm_forward` (kernels/grouped_matmul.py::VARIANTS).
constexpr int kSimt = 0, kTile = 1, kStream = 2;

// ---------------------------------------------------------------------------
// tile / stream: 3×TF32 mma.sync, fed by a cp.async ring
// ---------------------------------------------------------------------------
constexpr int kBK = tf32x3::kStageK;

template <int BM, int BN, int STAGES, bool XT, bool WT>
constexpr int mma_smem_bytes() {
  constexpr bool P = tf32x3::Permuted<XT, WT>::value;
  return STAGES *
         (tf32x3::Stage<BM, !XT, P>::kFloats +
          tf32x3::Stage<BN, WT, P>::kFloats) *
         static_cast<int>(sizeof(float));
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES,
          int MIN_BLOCKS, bool XT, bool WT>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, MIN_BLOCKS)
gmm_mma_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ y, float* __restrict__ partial,
               const int* __restrict__ ga, int G, int E, int M, int K, int N,
               int kchunk, int flags, long long x_gs, long long x_es,
               long long w_gs, long long w_es) {
  constexpr bool PERM = tf32x3::Permuted<XT, WT>::value;
  using SA = tf32x3::Stage<BM, !XT, PERM>;  // x: K-contiguous unless xᵀ
  using SB = tf32x3::Stage<BN, WT, PERM>;   // w: K-contiguous only as wᵀ
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(MT >= 1 && NT >= 1 && WTM % 16 == 0 && WTN % 8 == 0,
                "warp tile of whole m16n8 tiles");
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + STAGES * SA::kFloats;
  __shared__ long long xoff_row[BM];  // where row i's x values start
  __shared__ long long yoff_row[BM];  // where row i's outputs start
  __shared__ int live_row[BM];        // 1 live, 0 dead expert, -1 past the end

  const bool grouped = (flags & (kWPerGroup | kXTrans)) != 0;
  const int e = grouped ? blockIdx.z % E : blockIdx.z;
  const int g_blk = grouped ? blockIdx.z / E : 0;
  const int rows = grouped ? M : G * M;
  const int col_tiles = (N + BN - 1) / BN;
  const int split = blockIdx.x / col_tiles;
  const int c0 = (blockIdx.x - split * col_tiles) * BN;
  const int r0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  int live = 0;
  for (int i = tid; i < BM; i += kThreads) {
    const int r = r0 + i;
    const bool valid = r < rows;
    int g = g_blk, m = r;
    if (!grouped) {
      g = r / M;
      m = r - g * M;
    }
    const int lv = valid && (ga == nullptr || e < ga[g]) ? 1 : 0;
    live |= lv;
    live_row[i] = valid ? lv : -1;
    xoff_row[i] = valid ? (long long)g * x_gs + (long long)e * x_es +
                              (long long)m * (XT ? 1 : K)
                        : 0;
    yoff_row[i] = valid ? (((long long)g * E + e) * M + m) * N : 0;
  }
  // with a split contraction every chunk writes its partials, zeros too
  float* out =
      partial != nullptr ? partial + (size_t)split * G * E * M * N : y;
  if (!__syncthreads_or(live)) {  // no live row: no loads, zeros
    for (int i = tid; i < BM * BN; i += kThreads) {
      const int ri = i / BN, c = c0 + i % BN;
      if (live_row[ri] >= 0 && c < N) out[yoff_row[ri] + c] = 0.0f;
    }
    return;
  }
  const float* wb = w + (grouped && (flags & kWPerGroup)
                             ? (long long)g_blk * w_gs : 0) +
                    (long long)e * w_es;
  const int k_lo = split * kchunk;
  const int k_hi = min(K, k_lo + kchunk);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  TC_DECL;  // a stage of math a tile; the x and w tiles of a stage 2 blocks

  // One ring stage: the x tile (BM × kBK) and the w tile (kBK × BN) at
  // contraction offset k0, in 16-byte copies along each operand's stored
  // rows; bytes past the chunk end, a dead row, M or N read as zero.
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
        bytes = live_row[i] > 0 ? tf32x3::live_bytes(k_hi - k) : 0;
        if (bytes) src = x + xoff_row[i] + k;
      } else {    // xᵀ row k, x rows i .. i + 3 (one live (g, e))
        kk = c / (BM / 4);
        i = (c % (BM / 4)) * 4;
        const int k = k0 + kk;
        bytes = k < k_hi ? tf32x3::live_bytes(rows - (r0 + i)) : 0;
        if (bytes) src = x + xoff_row[i] + (long long)k * M;
      }
      tf32x3::cp_async16(as + SA::at(i, kk), src, bytes);
    }
    for (int c = tid; c < BN * kBK / 4; c += kThreads) {
      int j, kk, bytes;
      const float* src = wb;
      if (!WT) {  // w row k, columns j .. j + 3
        kk = c / (BN / 4);
        j = (c % (BN / 4)) * 4;
        const int k = k0 + kk, col = c0 + j;
        bytes = k < k_hi ? tf32x3::live_bytes(N - col) : 0;
        if (bytes) src = wb + (long long)k * N + col;
      } else {    // wᵀ row (column j), k .. k + 3
        j = c / (kBK / 4);
        kk = (c % (kBK / 4)) * 4;
        const int k = k0 + kk, col = c0 + j;
        bytes = col < N ? tf32x3::live_bytes(k_hi - k) : 0;
        if (bytes) src = wb + (long long)col * K + k;
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
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

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
    tf32x3::stage_mma<BM, BN, MT, NT, XT, WT>(
        As + (kt % STAGES) * SA::kFloats, Bs + (kt % STAGES) * SB::kFloats,
        wm, wn, g, t, acc);
    TC_TILES(1);
  }
  tf32x3::cp_async_wait<0>();
  TC_FLUSH(tid == 0);

  // epilogue: dead rows of a live tile write zeros
  const bool pairs = (N & 1) == 0;  // (offset + c) even: 8-byte stores
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ri = wm + i * 16 + g + 8 * h;
      const int lr = live_row[ri];
      if (lr < 0) continue;
      float* row_out = out + yoff_row[ri];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = c0 + wn + j * 8 + 2 * t;
        const float v0 = lr ? acc[i][j][2 * h] : 0.0f;
        const float v1 = lr ? acc[i][j][2 * h + 1] : 0.0f;
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

// split-K reduction: the chunks' partial sums added in a fixed order
__global__ void gmm_reduce_kernel(const float* __restrict__ partial,
                                  int splits, float* __restrict__ y,
                                  size_t total) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * total + i];
  y[i] = s;
}

// ---------------------------------------------------------------------------
// simt: 64 x 64 output tile, 4 x 4 outputs per thread (unaligned rows)
// ---------------------------------------------------------------------------
constexpr int kSBM = 64, kSBN = 64, kSBK = 16, kTM = 4, kTN = 4;
constexpr int kSimtThreads = (kSBM / kTM) * (kSBN / kTN);

__global__ void __launch_bounds__(kSimtThreads)
gmm_tiled_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ y, const int* __restrict__ ga, int G,
                 int E, int M, int K, int N, int flags, long long x_gs,
                 long long x_es, long long w_gs, long long w_es) {
  __shared__ float xs[kSBK][kSBM + 1];  // transposed x tile, padded
  __shared__ float ws[kSBK][kSBN + 1];
  __shared__ long long xoff_row[kSBM];  // where row i's x values start
  __shared__ long long yoff_row[kSBM];  // where row i's outputs start
  __shared__ int live_row[kSBM];
  const bool grouped = (flags & (kWPerGroup | kXTrans)) != 0;
  const bool x_trans = (flags & kXTrans) != 0;
  const bool w_trans = (flags & kWTrans) != 0;
  // the block's expert, and its group when the block owns one (g, e)
  const int e = grouped ? blockIdx.z % E : blockIdx.z;
  const int g_blk = grouped ? blockIdx.z / E : 0;
  const int rows = grouped ? M : G * M;
  const int r0 = blockIdx.y * kSBM, c0 = blockIdx.x * kSBN;
  const int tid = threadIdx.x;
  int live = 0;
  if (tid < kSBM) {
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
    for (int i = tid; i < kSBM * kSBN; i += kSimtThreads) {
      const int ri = i / kSBN, c = c0 + i % kSBN;
      if (live_row[ri] >= 0 && c < N) y[yoff_row[ri] + c] = 0.0f;
    }
    return;
  }
  const float* wb = w + (grouped && (flags & kWPerGroup)
                             ? (long long)g_blk * w_gs : 0) +
                    (long long)e * w_es;
  const int tx = tid % (kSBN / kTN), ty = tid / (kSBN / kTN);
  TC_DECL;  // a 16-deep step a tile; its x and w tiles 2 blocks
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kSBK) {
    TC_TILES(1);
    TC_DMA(2);
    // neighbouring threads take neighbouring addresses of the stored layout
    for (int i = tid; i < kSBM * kSBK; i += kSimtThreads) {
      int ri, kk;
      if (x_trans) { ri = i % kSBM; kk = i / kSBM; }
      else { ri = i / kSBK; kk = i - ri * kSBK; }
      const int k = k0 + kk;
      xs[kk][ri] = (live_row[ri] > 0 && k < K)
                       ? x[xoff_row[ri] + (x_trans ? (long long)k * M : k)]
                       : 0.0f;
    }
    for (int i = tid; i < kSBK * kSBN; i += kSimtThreads) {
      int kk, j;
      if (w_trans) { j = i / kSBK; kk = i - j * kSBK; }
      else { kk = i / kSBN; j = i - kk * kSBN; }
      const int k = k0 + kk, c = c0 + j;
      ws[kk][j] = (k < K && c < N)
                      ? wb[w_trans ? (long long)c * K + k
                                   : (long long)k * N + c]
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
    const int ri = ty * kTM + i;
    const int lr = live_row[ri];
    if (lr < 0) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = c0 + tx + j * (kSBN / kTN);
      if (c < N) y[yoff_row[ri] + c] = lr > 0 ? acc[i][j] : 0.0f;
    }
  }
  TC_FLUSH(tid == 0);
}

struct Args {
  const float* x;
  const float* w;
  float* y;
  float* partial;
  const int* ga;
  int G, E, M, K, N, kchunk, flags;
  long long x_gs, x_es, w_gs, w_es;
};

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES,
          int MIN_BLOCKS, bool XT, bool WT>
int launch_mma(const Args& a, int splits, unsigned row_tiles, unsigned zs,
               cudaStream_t s) {
  constexpr int kSmem = mma_smem_bytes<BM, BN, STAGES, XT, WT>();
  auto kernel = gmm_mma_kernel<BM, BN, WARPS_M, WARPS_N, STAGES, MIN_BLOCKS,
                               XT, WT>;
  static bool configured = false;  // once per instantiation (one card)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const unsigned cols = static_cast<unsigned>((a.N + BN - 1) / BN);
  dim3 grid(cols * static_cast<unsigned>(splits), row_tiles, zs);
  kernel<<<grid, WARPS_M * WARPS_N * 32, kSmem, s>>>(
      a.x, a.w, a.y, a.partial, a.ga, a.G, a.E, a.M, a.K, a.N, a.kchunk,
      a.flags, a.x_gs, a.x_es, a.w_gs, a.w_es);
  return 0;
}

}  // namespace

// C entry point, bound with ctypes. All pointers are device pointers; the
// wrapper has checked shapes, dtype (fp32) and device, and passes the plan
// of kernels/grouped_matmul.py::_plan: the variant (0 simt, 1 tile, 2
// stream), the row tile bm (64 for simt, 80 or 128 for tile, 16 / 32 / 64
// for stream), the number of contraction chunks and their length (a multiple
// of 32; one chunk for simt); partial is a (splits, G, E, M, N) fp32
// scratch buffer, null when splits == 1. The tile and stream variants take
// 16-byte-aligned operand rows and strides only (the plan checks). x is
// (G, E, M, K) (each (M, K) matrix row-major, or stored (K, M) with
// kXTrans), w is (E, K, N) or (G, E, K, N) with kWPerGroup (each (K, N)
// matrix row-major, or stored (N, K) with kWTrans); x_gs / x_es / w_gs /
// w_es are the elements between two groups' and two experts' matrices. y is
// (G, E, M, N), contiguous. A null ga means every expert is live in every
// group. Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int gmm_forward(const float* x, const float* w, float* y,
                           float* partial, const int* ga, int G, int E, int M,
                           int K, int N, int variant, int bm, int splits,
                           int kchunk, int flags, long long x_gs,
                           long long x_es, long long w_gs, long long w_es,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || E <= 0 || M <= 0 || N <= 0)
    return static_cast<int>(cudaGetLastError());
  if (splits < 1 || (splits > 1 && (partial == nullptr || variant == kSimt))
      || kchunk < 1 || (variant != kSimt && kchunk % kBK != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool grouped = (flags & (kWPerGroup | kXTrans)) != 0;
  const bool xt = (flags & kXTrans) != 0, wt = (flags & kWTrans) != 0;
  const long long rows = grouped ? M : (long long)G * M;
  const long long zs = grouped ? (long long)G * E : E;
  const long long row_tiles = (rows + bm - 1) / bm;
  if (zs > 65535 || row_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const Args a{x, w, y, splits > 1 ? partial : nullptr, ga, G, E, M, K, N,
               kchunk, flags, x_gs, x_es, w_gs, w_es};
  const unsigned ry = static_cast<unsigned>(row_tiles);
  const unsigned rz = static_cast<unsigned>(zs);
  int err = 0;
  if (variant == kTile && bm == 80 && !xt && !wt) {
    err = launch_mma<80, 128, 1, 4, 3, 2, false, false>(a, splits, ry, rz, s);
  } else if (variant == kTile && bm == 80 && !xt && wt) {
    err = launch_mma<80, 128, 1, 4, 3, 2, false, true>(a, splits, ry, rz, s);
  } else if (variant == kTile && bm == 80 && xt && !wt) {
    err = launch_mma<80, 128, 1, 4, 3, 2, true, false>(a, splits, ry, rz, s);
  } else if (variant == kTile && bm == 128 && !xt && !wt) {
    err = launch_mma<128, 128, 2, 4, 3, 2, false, false>(a, splits, ry, rz, s);
  } else if (variant == kTile && bm == 128 && !xt && wt) {
    err = launch_mma<128, 128, 2, 4, 3, 2, false, true>(a, splits, ry, rz, s);
  } else if (variant == kTile && bm == 128 && xt && !wt) {
    err = launch_mma<128, 128, 2, 4, 3, 2, true, false>(a, splits, ry, rz, s);
  } else if (variant == kStream && !xt && !wt && bm == 16) {
    err = launch_mma<16, 128, 1, 4, 3, 3, false, false>(a, splits, ry, rz, s);
  } else if (variant == kStream && !xt && !wt && bm == 32) {
    err = launch_mma<32, 128, 1, 4, 3, 3, false, false>(a, splits, ry, rz, s);
  } else if (variant == kStream && !xt && !wt && bm == 64) {
    err = launch_mma<64, 128, 1, 4, 3, 2, false, false>(a, splits, ry, rz, s);
  } else if (variant == kSimt && bm == kSBM && splits == 1) {
    dim3 grid((N + kSBN - 1) / kSBN, static_cast<unsigned>((rows + kSBM - 1)
                                                           / kSBM), rz);
    gmm_tiled_kernel<<<grid, kSimtThreads, 0, s>>>(x, w, y, ga, G, E, M, K, N,
                                                   flags, x_gs, x_es, w_gs,
                                                   w_es);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  if (splits > 1) {
    const size_t total = (size_t)G * E * M * N;
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((total + threads - 1) /
                                                  threads);
    gmm_reduce_kernel<<<blocks, threads, 0, s>>>(partial, splits, y, total);
  }
  return static_cast<int>(cudaGetLastError());
}
