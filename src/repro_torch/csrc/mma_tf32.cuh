// mma_tf32.cuh — fp32 products on Hopper's tensor cores at about fp32
// accuracy ("3×TF32"), and the 16-byte cp.async copies that feed them.
// Shared by csrc/elastic_dense.cu (K1) and csrc/flash_attention_fwd.cu (K2).
//
// A TF32 tensor-core product keeps 10 bits of each operand's mantissa;
// fp32 keeps 23. Each operand is split where its fragment is loaded from
// shared memory, v ≈ hi + lo: hi the nearest TF32 value (round to nearest,
// ties away from zero, as `cvt.rna.tf32.f32`), lo the remainder, which the
// tensor core reads truncated to TF32 (`split`). A product is taken as
//
//     a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi
//
// (a_lo·b_lo, about 2^-22 of a·b, is dropped). The tensor core's fp32
// accumulation does not round to nearest at every step, so a long
// contraction must not run its whole sum through it: `mma3_add` sums the
// three products of one 8-deep step into a fresh tile and adds that tile
// into the caller's accumulator with ordinary fp32 adds. The error of a
// K-long sum is then that of an fp32 sum of K/8 terms, not of K tensor-core
// accumulations (tests/test_torch_tf32_split.py emulates the split on the
// CPU and shows why all three products are needed).
//
// Fragment layouts of `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`
// (g = lane / 4, t = lane % 4):
//   A (16 × 8):  a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)   a3 (g + 8, t + 4)
//   B (8 × 8):   b0 (k = t, n = g)           b1 (k = t + 4, n = g)
//   C (16 × 8):  c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// A sum over k does not care which k sits in which slot, as long as A and
// B agree: the kernels put k = 2t in slot t and k = 2t + 1 in slot t + 4,
// so a thread's two values of a K-contiguous operand row are neighbours
// and load as one 64-bit word.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// The TF32 value nearest to v (ties away from zero), as
// `cvt.rna.tf32.f32` gives it, in two integer operations on the bits (a
// carry into the exponent is the rounding up it should be).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v ≈ hi + lo: hi the nearest TF32 value, lo = v - hi exactly (|lo| ≤
// 2^-11 |v|). lo goes to the tensor core as it is, which reads a TF32
// operand's top 19 bits and ignores the rest — lo truncated toward zero,
// an error of at most 2^-21 |v|, below the dropped lo·lo term's 2^-22
// only by a factor of two and far below fp32 parity's needs.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a · b on one m16n8k8 tile, accumulated by the tensor core.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a · b for one 8-deep step in 3×TF32, accumulated in the tensor
// core: for short contractions (a few dozen accumulations).
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(acc, al, bh);
  mma(acc, ah, bl);
  mma(acc, ah, bh);
}

// acc += a · b for one 8-deep step in 3×TF32: the three products summed
// (smallest first) in a fresh tile, then added to acc in IEEE fp32.
__device__ __forceinline__ void mma3_add(float (&acc)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma(t, al, bh);
  mma(t, ah, bl);
  mma(t, ah, bh);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

// 16-byte global -> shared copy; only the first `bytes` (0..16) are read,
// the rest of the 16 written as zeros. With bytes == 0 nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Bytes (0, 4, 8, 12 or 16) of a 4-float copy of which `n` floats are live.
__device__ __forceinline__ int live_bytes(int n) {
  return n >= 4 ? 16 : (n > 0 ? 4 * n : 0);
}

}  // namespace tf32x3
