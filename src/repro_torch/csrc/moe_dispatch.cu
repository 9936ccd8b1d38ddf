// moe_dispatch — MoE token movement, fp32, for sm_90a: a row gather (K6)
// and a gather-reduce (K7).
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
// What bounds them on the H100: pure row movement, no arithmetic to speak
// of — the bytes of the rows read and written over 3.35 TB/s. At the
// training shapes (4 clients × 32 experts × 160 slots of d = 1024 fp32)
// K6 moves ~84 MB out and as much in; K7 reads ≤ k rows per token.
//
// What the design does about it:
//  * K6: one warp per output row, 16-byte (float4) copies of the d-row
//    when d and the pointers allow it; an invalid row writes zeros and
//    reads nothing. The values are copied bit for bit.
//  * K7: one block per token; each thread owns float4 columns of the row
//    and sums the k gathered rows into an fp32 register in the fixed order
//    j = 0 … k−1, no atomics (deterministic). An assignment with gate 0
//    (dropped by capacity, or to a masked expert) reads no row: it would
//    add exactly 0 for finite rows.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 8;  // K6: one warp per row
constexpr int kReduceThreads = 128;

__device__ __forceinline__ long long clamp_row(int i, int n_src) {
  return i < 0 ? 0 : (i >= n_src ? n_src - 1 : i);
}

template <bool kVec>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
gather_rows_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   const int* __restrict__ valid, float* __restrict__ out,
                   int R, int n_src, int d) {
  const int r = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  const bool ok = valid[r] != 0;
  const long long src = ok ? clamp_row(idx[r], n_src) : 0;
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
gather_reduce_kernel(const float* __restrict__ y, const int* __restrict__ dest,
                     const float* __restrict__ gates, float* __restrict__ out,
                     int k, int n_src, int d) {
  const long long t = blockIdx.x;
  const int* dt = dest + t * k;
  const float* gt = gates + t * k;
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

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// C entry points, bound with ctypes. All pointers are device pointers; the
// wrapper has checked shapes, dtypes (fp32 rows and gates, int32 indices),
// contiguity and device. Each returns cudaGetLastError() after its launch
// (0 = launched).

// K6: out (R, d) from x (n_src, d), idx and valid (R,).
extern "C" int gather_rows_forward(const float* x, const int* idx,
                                   const int* valid, float* out, int R,
                                   int n_src, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (n_src <= 0) {  // nothing to gather: every row reads as invalid
    cudaMemsetAsync(out, 0, sizeof(float) * (size_t)R * d, s);
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  if (d % 4 == 0 && aligned16(x) && aligned16(out))
    gather_rows_kernel<true><<<blocks, kRowsPerBlock * 32, 0, s>>>(
        x, idx, valid, out, R, n_src, d);
  else
    gather_rows_kernel<false><<<blocks, kRowsPerBlock * 32, 0, s>>>(
        x, idx, valid, out, R, n_src, d);
  return static_cast<int>(cudaGetLastError());
}

// K7: out (T, d) from y (n_src, d), dest and gates (T, k).
extern "C" int gather_reduce_forward(const float* y, const int* dest,
                                     const float* gates, float* out, int T,
                                     int k, int n_src, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (n_src <= 0 || k <= 0) {  // no row to gather: the sums are empty
    cudaMemsetAsync(out, 0, sizeof(float) * (size_t)T * d, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (d % 4 == 0 && aligned16(y) && aligned16(out))
    gather_reduce_kernel<true><<<T, kReduceThreads, 0, s>>>(
        y, dest, gates, out, k, n_src, d);
  else
    gather_reduce_kernel<false><<<T, kReduceThreads, 0, s>>>(
        y, dest, gates, out, k, n_src, d);
  return static_cast<int>(cudaGetLastError());
}
