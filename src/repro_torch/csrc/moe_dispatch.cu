// moe_dispatch — MoE token movement, fp32, for sm_90a: a row gather (K6,
// with a per-row scale and a gather-dot beside the copy) and a
// gather-reduce (K7).
//
// Replace the Pallas TPU kernels of src/repro/kernels/moe_dispatch.py:
//
//   K6 `_gather_kernel` / `gather_rows`:
//       out[r] = x[idx[r]] if valid[r] else 0          x (R_src, d), idx and
//                                                       valid (R,) int32
//   K7 `_gather_reduce_kernel` / `gather_reduce`:
//       out[t] = Σ_j gates[t, j] · y[dest[t, j]]        y (R_src, d), dest
//                                                       and gates (T, k)
//
// the dispatch direction (tokens into expert capacity slots) and the combine
// direction (slots back to tokens, weighted by the router's gates). Their
// VJPs are each other (see kernels/moe_dispatch.py), so the training pass
// launches both kernels in both directions. Indices are clamped into
// [0, R_src) as in the reference. A group axis (clients, decode slots) is
// flattened into the rows by the caller: the contracts stay 1-D.
//
// The combine's VJP (the reference's `_make_combine` bwd) gathers each
// slot's token cotangent times the slot's gate, and contracts the token
// cotangent with each row the token gathered. Two more functions of K6 do
// those in one pass each, so no (R, d) or (T·k, d) intermediate is
// written:
//   scaled gather  out[r] = scale[r] · x[idx[r]] if valid[r] else 0 (one
//                  fp32 multiply: bit-equal to the copy times the scale);
//   gather-dot     out[t, j] = Σ_c z[t, c] · x[idx[t·k + j], c] if
//                  valid[t·k + j] else 0.
//
// What bounds them on the H100: pure row movement, no arithmetic to speak
// of — the bytes of the rows read and written over 3.35 TB/s. At the
// training shapes (4 clients × 32 experts × 160 slots of d = 1024 fp32)
// K6 writes ~84 MB and reads the valid rows; K7 reads ≤ k rows per token.
// What holds a gather back is how many loads are in flight, and at decode
// (2 tokens, 512 slots) how many SMs take part.
//
// The design (the `unrolled` / `split` variants of the wrappers):
//  * K6 copy and scaled gather: a warp per output row; each lane issues its
//    eight 16-byte loads of a 4 KB row slice before any store, so a warp
//    has 4 KB in flight. An invalid row writes zeros and reads nothing. The
//    warps a block (8, 4, 2 or 1) come from R and the SM count alone
//    (never the indices), so that a decode step's 512 rows span the SMs.
//  * gather-dot: 1, 2 or 4 warps a token, each a slice of the columns (the
//    fewest that give 16 warps an SM: 2 at the training combine); each
//    lane loads the token's z vector once and the k rows' vectors beside
//    it (k + 1 loads in flight), keeps k fp32 sums in registers, the warp
//    sums them by a butterfly and the slices' sums add in slice order:
//    deterministic, no atomics.
//  * K7: a warp per (token, 32 16-byte column vectors); lane j < k loads
//    the token's (dest, gate) pair j once and the warp shares them by
//    shuffles; every lane then issues its k row loads (each only where the
//    gate is not 0) before the k FMAs, which run in the order
//    j = 0 … k−1 from 0 — bit-equal to the first design — and writes its
//    vector with a streaming store. k is a template parameter for the
//    zoo's values (1, 2, 6, 8), with a generic path in groups of 8. The
//    warps a block come from T, d and the SM count alone: a 2-token decode
//    step runs 16 one-warp blocks, on 16 SMs.
//
// The first design stays, selectable as the `first` variant for
// measurement and tests: K6 one warp per row with one 16-byte copy per
// lane in flight, 8 rows a block; K7 one 128-thread block per token with
// the gate and index reloaded for every column and the row loads behind a
// branch.
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_counters.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long clamp_row(int i, int n_src) {
  return i < 0 ? 0 : (i >= n_src ? n_src - 1 : i);
}

// ---------------------------------------------------------------------------
// element helpers: a float4 (16-byte) vector or a single float
// ---------------------------------------------------------------------------
template <bool kVec>
struct Vec {
  using T = float4;
  static constexpr int kW = 4;
};
template <>
struct Vec<false> {
  using T = float;
  static constexpr int kW = 1;
};

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.0f;
}

__device__ __forceinline__ float4 load(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float4 scaled(float4 v, float s) {
  return make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s), __fmul_rn(v.z, s),
                     __fmul_rn(v.w, s));
}
__device__ __forceinline__ float scaled(float v, float s) {
  return __fmul_rn(v, s);
}

// acc += g · v, one fmaf per element
__device__ __forceinline__ void fma_into(float4& acc, float g, float4 v) {
  acc.x = fmaf(g, v.x, acc.x);
  acc.y = fmaf(g, v.y, acc.y);
  acc.z = fmaf(g, v.z, acc.z);
  acc.w = fmaf(g, v.w, acc.w);
}
__device__ __forceinline__ void fma_into(float& acc, float g, float v) {
  acc = fmaf(g, v, acc);
}

// acc + Σ_e z_e · v_e, in element order
__device__ __forceinline__ float dot_into(float acc, float4 z, float4 v) {
  acc = fmaf(z.x, v.x, acc);
  acc = fmaf(z.y, v.y, acc);
  acc = fmaf(z.z, v.z, acc);
  return fmaf(z.w, v.w, acc);
}
__device__ __forceinline__ float dot_into(float acc, float z, float v) {
  return fmaf(z, v, acc);
}

// ===========================================================================
// The first design, kept for measurement and tests
// ===========================================================================
constexpr int kRowsPerBlock = 8;  // K6: one warp per row
constexpr int kReduceThreads = 128;

template <bool kVec>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
gather_rows_first_kernel(const float* __restrict__ x,
                         const int* __restrict__ idx,
                         const int* __restrict__ valid,
                         float* __restrict__ out, int R, int n_src, int d) {
  const int r = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  const bool ok = valid[r] != 0;
  const long long src = ok ? clamp_row(idx[r], n_src) : 0;
  TC_DECL;  // a warp's row: a source row read is a tile and a block
  if (ok) {
    TC_TILES(1);
    TC_DMA(1);
  }
  TC_FLUSH(lane == 0);
  if (kVec) {
    const int d4 = d >> 2;
    const float4* xr = reinterpret_cast<const float4*>(x + src * d);
    float4* orow = reinterpret_cast<float4*>(out + (long long)r * d);
    for (int c = lane; c < d4; c += 32)
      orow[c] = ok ? __ldg(&xr[c]) : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    const float* xr = x + src * d;
    float* orow = out + (long long)r * d;
    for (int c = lane; c < d; c += 32) orow[c] = ok ? __ldg(&xr[c]) : 0.0f;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kReduceThreads)
gather_reduce_first_kernel(const float* __restrict__ y,
                           const int* __restrict__ dest,
                           const float* __restrict__ gates,
                           float* __restrict__ out, int k, int n_src,
                           int d) {
  const long long t = blockIdx.x;
  const int* dt = dest + t * k;
  const float* gt = gates + t * k;
#ifdef REPRO_TILE_COUNTERS
  TC_DECL;  // the token's rows read (gate ≠ 0): a tile and a block each
  for (int j = 0; j < k; ++j) {
    if (gt[j] != 0.0f) {
      TC_TILES(1);
      TC_DMA(1);
    }
  }
  TC_FLUSH(threadIdx.x == 0);
#endif
  if (kVec) {
    const int d4 = d >> 2;
    float4* orow = reinterpret_cast<float4*>(out + t * d);
    for (int c = threadIdx.x; c < d4; c += kReduceThreads) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < k; ++j) {
        const float g = __ldg(&gt[j]);
        if (g == 0.0f) continue;
        const float4 v = __ldg(reinterpret_cast<const float4*>(
                                   y + clamp_row(__ldg(&dt[j]), n_src) * d) +
                               c);
        acc.x = fmaf(g, v.x, acc.x);
        acc.y = fmaf(g, v.y, acc.y);
        acc.z = fmaf(g, v.z, acc.z);
        acc.w = fmaf(g, v.w, acc.w);
      }
      orow[c] = acc;
    }
  } else {
    float* orow = out + t * d;
    for (int c = threadIdx.x; c < d; c += kReduceThreads) {
      float acc = 0.0f;
      for (int j = 0; j < k; ++j) {
        const float g = __ldg(&gt[j]);
        if (g == 0.0f) continue;
        acc = fmaf(g, __ldg(&y[clamp_row(__ldg(&dt[j]), n_src) * d + c]),
                   acc);
      }
      orow[c] = acc;
    }
  }
}

// ===========================================================================
// The redesign
// ===========================================================================
constexpr int kUnroll = 8;    // K6: vectors a lane loads before it stores
constexpr int kMaxWarps = 8;  // warps a block, at most
constexpr int kDotWarps = 4;  // gather-dot: warps a block

// K6, copy (kScale false) or scaled gather: a warp per row.
template <bool kVec, bool kScale>
__global__ void __launch_bounds__(kMaxWarps * 32)
gather_rows_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   const int* __restrict__ valid,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int R, int n_src, int d) {
  using V = typename Vec<kVec>::T;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  const bool ok = __ldg(&valid[r]) != 0;
  const long long src = ok ? clamp_row(__ldg(&idx[r]), n_src) : 0;
  const float s = (kScale && ok) ? __ldg(&scale[r]) : 1.0f;
  TC_DECL;  // a warp's row: a source row read is a tile and a block
  if (ok) {
    TC_TILES(1);
    TC_DMA(1);
  }
  TC_FLUSH(lane == 0);
  const int n = d / Vec<kVec>::kW;  // vectors a row
  const V* xr = reinterpret_cast<const V*>(x + src * d);
  V* orow = reinterpret_cast<V*>(out + (long long)r * d);
  for (int c0 = lane; c0 < n; c0 += 32 * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u;
      v[u] = (ok && c < n) ? load(xr + c) : zero<V>();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u;
      if (c < n) orow[c] = (kScale && ok) ? scaled(v[u], s) : v[u];
    }
  }
}

// K6, gather-dot: `split` warps a token, each a slice of the columns; KC
// assignments a pass (all k when KC == k, else groups of KC).
template <bool kVec, int KC>
__global__ void __launch_bounds__(kDotWarps * 32)
gather_dot_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                  const int* __restrict__ valid, const float* __restrict__ z,
                  float* __restrict__ out, int T, int k, int n_src, int d,
                  int split) {
  using V = typename Vec<kVec>::T;
  __shared__ float part[kDotWarps][KC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * (kDotWarps / split) +
                      warp / split;
  const int w = warp % split;  // the warp's column slice
  const bool tok = t < T;
  const int n = d / Vec<kVec>::kW;
  const int span = (n + split - 1) / split;
  const int c_hi = min(n, (w + 1) * span);
  const V* zr = reinterpret_cast<const V*>(z + (tok ? t : 0) * d);
  TC_DECL;  // a token's valid assignments: a tile and a block each; its
            // z row a block (counted by the token's first warp)
  if (tok) TC_DMA(1);
  for (int j0 = 0; j0 < k; j0 += KC) {
    // lane j < KC loads assignment j0 + j once; the warp shares them
    int my_ok = 0, my_src = 0;
    if (tok && lane < KC && j0 + lane < k) {
      const long long a = t * k + j0 + lane;
      my_ok = __ldg(&valid[a]) != 0;
      my_src = my_ok ? static_cast<int>(clamp_row(__ldg(&idx[a]), n_src)) : 0;
    }
    const V* xr[KC];
    bool ok[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      ok[j] = __shfl_sync(kFull, my_ok, j) != 0;
      xr[j] = reinterpret_cast<const V*>(
          x + (long long)__shfl_sync(kFull, my_src, j) * d);
      if (ok[j]) {
        TC_TILES(1);
        TC_DMA(1);
      }
    }
    float acc[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[j] = 0.0f;
    if (tok) {
      for (int c = w * span + lane; c < c_hi; c += 32) {
        const V zv = load(zr + c);
        V v[KC];
#pragma unroll
        for (int j = 0; j < KC; ++j) v[j] = ok[j] ? load(xr[j] + c) : zero<V>();
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[j] = dot_into(acc[j], zv, v[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KC; ++j)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[j] += __shfl_xor_sync(kFull, acc[j], off);
    if (split > 1) {  // the slices' sums, in slice order
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < KC; ++j) part[warp][j] = acc[j];
      }
      __syncthreads();
      if (w == 0) {
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          float sum = part[warp][j];
          for (int q = 1; q < split; ++q) sum += part[warp + q][j];
          acc[j] = sum;
        }
      }
      __syncthreads();  // part is rewritten by the next group
    }
    if (tok && w == 0 && lane == 0) {
#pragma unroll
      for (int j = 0; j < KC; ++j)
        if (j0 + j < k) out[t * k + j0 + j] = ok[j] ? acc[j] : 0.0f;
    }
  }
  TC_FLUSH(tok && w == 0 && lane == 0);
}

// K7: a warp per (token, 32 column vectors); KC assignments a pass.
template <bool kVec, int KC>
__global__ void __launch_bounds__(kMaxWarps * 32)
gather_reduce_kernel(const float* __restrict__ y,
                     const int* __restrict__ dest,
                     const float* __restrict__ gates,
                     float* __restrict__ out, int T, int k, int n_src,
                     int d) {
  using V = typename Vec<kVec>::T;
  const int n = d / Vec<kVec>::kW;
  const int chunks = (n + 31) / 32;
  const long long wid = (long long)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (wid >= (long long)T * chunks) return;  // uniform over the warp
  const long long t = wid / chunks;
  const int c = static_cast<int>(wid % chunks) * 32 + lane;
  const bool col = c < n;
  V acc = zero<V>();
  TC_DECL;  // the token's rows read (gate ≠ 0): a tile and a block each,
            // counted by the warp of its first 32 column vectors
  for (int j0 = 0; j0 < k; j0 += KC) {
    int my_dest = 0;
    float my_gate = 0.0f;
    if (lane < KC && j0 + lane < k) {
      my_gate = __ldg(&gates[t * k + j0 + lane]);
      my_dest = __ldg(&dest[t * k + j0 + lane]);
    }
    float g[KC];
    V v[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {  // every row load before the first FMA
      g[j] = __shfl_sync(kFull, my_gate, j);
      const long long row = clamp_row(__shfl_sync(kFull, my_dest, j), n_src);
      v[j] = (g[j] != 0.0f && col)
                 ? load(reinterpret_cast<const V*>(y + row * d) + c)
                 : zero<V>();
      if (g[j] != 0.0f) {
        TC_TILES(1);
        TC_DMA(1);
      }
    }
#pragma unroll
    for (int j = 0; j < KC; ++j)  // j = 0 … k−1, a gate of 0 adds nothing
      if (g[j] != 0.0f) fma_into(acc, g[j], v[j]);
  }
  if (col) __stcs(reinterpret_cast<V*>(out + t * d) + c, acc);
  TC_FLUSH(wid % chunks == 0 && lane == 0);
}

template <bool kVec>
void launch_reduce(unsigned blocks, int warps, cudaStream_t s,
                   const float* y, const int* dest, const float* gates,
                   float* out, int T, int k, int n_src, int d) {
#define K7_LAUNCH(KC)                                                   \
  gather_reduce_kernel<kVec, KC><<<blocks, warps * 32, 0, s>>>(         \
      y, dest, gates, out, T, k, n_src, d)
  switch (k) {
    case 1: K7_LAUNCH(1); break;
    case 2: K7_LAUNCH(2); break;
    case 6: K7_LAUNCH(6); break;
    case 8: K7_LAUNCH(8); break;
    default: K7_LAUNCH(8); break;  // generic: groups of 8
  }
#undef K7_LAUNCH
}

template <bool kVec>
void launch_dot(unsigned blocks, int split, cudaStream_t s, const float* x,
                const int* idx, const int* valid, const float* z,
                float* out, int T, int k, int n_src, int d) {
#define K6_DOT(KC)                                                      \
  gather_dot_kernel<kVec, KC><<<blocks, kDotWarps * 32, 0, s>>>(        \
      x, idx, valid, z, out, T, k, n_src, d, split)
  switch (k) {
    case 1: K6_DOT(1); break;
    case 2: K6_DOT(2); break;
    case 6: K6_DOT(6); break;
    case 8: K6_DOT(8); break;
    default: K6_DOT(8); break;  // generic: groups of 8
  }
#undef K6_DOT
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

bool valid_warps(int warps) {
  return warps == 1 || warps == 2 || warps == 4 || warps == 8;
}

}  // namespace

// C entry points, bound with ctypes. All pointers are device pointers; the
// wrapper has checked shapes, dtypes (fp32 rows, gates and scales, int32
// indices), contiguity and device, and chosen the launch (`vec`: the rows
// are read and written as 16-byte vectors — d a multiple of 4 and every
// row pointer 16-byte aligned; `warps` a block or `split` warps a token,
// from kernels/moe_dispatch.py's plans). `variant`: 0 the first design, 1
// the redesign (the order of the wrappers' variant tuples). Each returns
// cudaGetLastError() after its launch (0 = launched).

// K6: out (R, d) from x (n_src, d), idx and valid (R,); scale (R,) or null.
extern "C" int gather_rows_forward(const float* x, const int* idx,
                                   const int* valid, const float* scale,
                                   float* out, int R, int n_src, int d,
                                   int vec, int variant, int warps,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (n_src <= 0) {  // nothing to gather: every row reads as invalid
    cudaMemsetAsync(out, 0, sizeof(float) * (size_t)R * d, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == 0) {
    if (scale != nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
    if (d % 4 == 0 && aligned16(x) && aligned16(out))
      gather_rows_first_kernel<true><<<blocks, kRowsPerBlock * 32, 0, s>>>(
          x, idx, valid, out, R, n_src, d);
    else
      gather_rows_first_kernel<false><<<blocks, kRowsPerBlock * 32, 0, s>>>(
          x, idx, valid, out, R, n_src, d);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != 1 || !valid_warps(warps))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (R + warps - 1) / warps;
#define K6_ROWS(VEC, SCALE)                                              \
  gather_rows_kernel<VEC, SCALE><<<blocks, warps * 32, 0, s>>>(          \
      x, idx, valid, scale, out, R, n_src, d)
  if (vec) {
    if (scale) K6_ROWS(true, true); else K6_ROWS(true, false);
  } else {
    if (scale) K6_ROWS(false, true); else K6_ROWS(false, false);
  }
#undef K6_ROWS
  return static_cast<int>(cudaGetLastError());
}

// K6's gather-dot: out (T, k) from x (n_src, d), idx and valid (T·k,) and
// z (T, d).
extern "C" int gather_dot_forward(const float* x, const int* idx,
                                  const int* valid, const float* z,
                                  float* out, int T, int k, int n_src, int d,
                                  int vec, int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (n_src <= 0 || d <= 0) {  // no row to gather: every dot is empty
    cudaMemsetAsync(out, 0, sizeof(float) * (size_t)T * k, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (split != 1 && split != 2 && split != 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kDotWarps / split;
  const unsigned blocks = (T + per_block - 1) / per_block;
  if (vec)
    launch_dot<true>(blocks, split, s, x, idx, valid, z, out, T, k, n_src,
                     d);
  else
    launch_dot<false>(blocks, split, s, x, idx, valid, z, out, T, k, n_src,
                      d);
  return static_cast<int>(cudaGetLastError());
}

// K7: out (T, d) from y (n_src, d), dest and gates (T, k).
extern "C" int gather_reduce_forward(const float* y, const int* dest,
                                     const float* gates, float* out, int T,
                                     int k, int n_src, int d, int vec,
                                     int variant, int warps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (n_src <= 0 || k <= 0) {  // no row to gather: the sums are empty
    cudaMemsetAsync(out, 0, sizeof(float) * (size_t)T * d, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == 0) {
    if (d % 4 == 0 && aligned16(y) && aligned16(out))
      gather_reduce_first_kernel<true><<<T, kReduceThreads, 0, s>>>(
          y, dest, gates, out, k, n_src, d);
    else
      gather_reduce_first_kernel<false><<<T, kReduceThreads, 0, s>>>(
          y, dest, gates, out, k, n_src, d);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != 1 || !valid_warps(warps))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = vec ? d / 4 : d;
  const long long warps_total = (long long)T * ((n + 31) / 32);
  const unsigned blocks =
      static_cast<unsigned>((warps_total + warps - 1) / warps);
  if (vec)
    launch_reduce<true>(blocks, warps, s, y, dest, gates, out, T, k, n_src,
                        d);
  else
    launch_reduce<false>(blocks, warps, s, y, dest, gates, out, T, k, n_src,
                         d);
  return static_cast<int>(cudaGetLastError());
}
