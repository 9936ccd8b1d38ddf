// mma_tf32.cuh — fp32 products on Hopper's tensor cores at about fp32
// accuracy ("3×TF32"), the 16-byte cp.async copies that feed them, and the
// ring-stage tile of a matrix product. Shared by csrc/elastic_dense.cu
// (K1), csrc/flash_attention_fwd.cu (K2), csrc/flash_attention_bwd.cu (K3,
// K4), csrc/grouped_matmul.cu (K5) and csrc/ssd_scan.cu (K8).
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

// 4-byte global -> shared copy (one float); with bytes == 0 nothing is
// read and a zero is written.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
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

// ---------------------------------------------------------------------------
// The ring-stage tile of K1 and K5: a block's BM × BN output tile in warp
// tiles of MT × NT m16n8 tiles, fed kStageK-deep stages of both operands
// through a cp.async ring in shared memory.
// ---------------------------------------------------------------------------
constexpr int kStageK = 32;  // contraction depth of one ring stage

// One operand's stage in shared memory: ROWS (M or N) by kStageK, stored
// K-contiguous ([ROWS][kStageK + pad]) or rows-contiguous ([kStageK][ROWS +
// 4]). A warp's fragment loads take rows g < 8 at two k per thread. In the
// permuted k order above (PERM: k = 2t, 2t + 1) a K-contiguous row pads to
// kStageK + 8 and its pair loads as one 64-bit word (words 8g + 2t:
// distinct banks), a rows-contiguous one to ROWS + 4 (words 8t + g, ROWS a
// multiple of 16). When both operands are K-contiguous (a product with wᵀ
// read in place) the k order stays native (k = t, t + 4) and the rows pad
// to kStageK + 4 (words 4g + t): 12 % less shared memory, so that two
// blocks fit an SM, for scalar loads. Every row stays 16-byte aligned.
template <int ROWS, bool KCONTIG, bool PERM>
struct Stage {
  static constexpr int kStride =
      KCONTIG ? kStageK + (PERM ? 8 : 4) : ROWS + 4;
  static constexpr int kFloats =
      KCONTIG ? ROWS * kStride : kStageK * kStride;
  __device__ __forceinline__ static int at(int row, int k) {
    return KCONTIG ? row * kStride + k : k * kStride + row;
  }
};

// The permuted k order, unless both operands are K-contiguous. XT: the
// row operand (x) is stored transposed, rows-contiguous; WT: the column
// operand (w) is stored transposed, K-contiguous.
template <bool XT, bool WT>
struct Permuted {
  static constexpr bool value = XT || !WT;
};

// acc += the warp's share of one ring stage: the rows [wm, wm + 16·MT) of
// the stage's x tile `as` times the columns [wn, wn + 8·NT) of its w tile
// `bs`, kStageK / 8 steps of mma3_add (g = lane / 4, t = lane % 4).
template <int BM, int BN, int MT, int NT, bool XT, bool WT>
__device__ __forceinline__ void stage_mma(const float* as, const float* bs,
                                          int wm, int wn, int g, int t,
                                          float (&acc)[MT][NT][4]) {
  constexpr bool PERM = Permuted<XT, WT>::value;
  using SA = Stage<BM, !XT, PERM>;  // x: K-contiguous unless transposed
  using SB = Stage<BN, WT, PERM>;   // w: K-contiguous only when transposed
#pragma unroll
  for (int kk = 0; kk < kStageK; kk += 8) {
    // B fragments of the warp's NT column tiles, then one row tile at a
    // time: its A fragment and its NT products (fewer live registers)
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = wn + j * 8 + g;
      float b0, b1;
      if (!PERM) {
        b0 = bs[SB::at(col, kk + t)];
        b1 = bs[SB::at(col, kk + t + 4)];
      } else if (WT) {
        const float2 v = *reinterpret_cast<const float2*>(
            bs + SB::at(col, kk + 2 * t));
        b0 = v.x;
        b1 = v.y;
      } else {
        b0 = bs[SB::at(col, kk + 2 * t)];
        b1 = bs[SB::at(col, kk + 2 * t + 1)];
      }
      split(b0, bh[j][0], bl[j][0]);
      split(b1, bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int row = wm + i * 16 + g;
      float a[4];
      if (!PERM) {
        a[0] = as[SA::at(row, kk + t)];
        a[2] = as[SA::at(row, kk + t + 4)];
        a[1] = as[SA::at(row + 8, kk + t)];
        a[3] = as[SA::at(row + 8, kk + t + 4)];
      } else if (!XT) {
        const float2 v0 = *reinterpret_cast<const float2*>(
            as + SA::at(row, kk + 2 * t));
        const float2 v1 = *reinterpret_cast<const float2*>(
            as + SA::at(row + 8, kk + 2 * t));
        a[0] = v0.x;
        a[2] = v0.y;
        a[1] = v1.x;
        a[3] = v1.y;
      } else {
        a[0] = as[SA::at(row, kk + 2 * t)];
        a[2] = as[SA::at(row, kk + 2 * t + 1)];
        a[1] = as[SA::at(row + 8, kk + 2 * t)];
        a[3] = as[SA::at(row + 8, kk + 2 * t + 1)];
      }
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma3_add(acc[i][j], ah, al, bh[j], bl[j]);
    }
  }
}

}  // namespace tf32x3
