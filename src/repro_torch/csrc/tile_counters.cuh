// tile_counters.cuh — launch-geometry counters inside the kernels, compiled
// in only on request.
//
// The tile-accounting gate (src/repro_torch/launch/elastic_kernels.py) holds
// what each kernel really executed against a host model of its launch plan
// (src/repro_torch/launch/roofline.py): the tiles whose math issued and the
// DMA blocks (operand tiles, stages or rows) whose loads issued. Both
// counts come from the kernels' own loops through these macros:
//
//   TC_DECL;            a block's (or a row kernel's warp's) two counts, 0
//   TC_TILES(n);        n more tiles executed
//   TC_DMA(n);          n more operand blocks loaded
//   TC_FLUSH(leader);   one atomicAdd each, by the thread `leader` is true on
//
// Every thread of a block runs the increments on block-uniform paths and
// one thread adds the block's counts to the library's two device counters,
// so the counters cost two atomics a block, never one per copy.
//
// kernels/build.py compiles each source twice: the fast library without
// REPRO_TILE_COUNTERS, where every macro expands to nothing (the same
// kernels, registers and times as a source without them), and the counted
// library `<name>_counted_<hash>.so` with -DREPRO_TILE_COUNTERS, which
// alone exports `tile_counters_reset` and `tile_counters_read`. The
// counted libraries load only inside `build.counting()`.
#pragma once

#ifdef REPRO_TILE_COUNTERS
#include <cuda_runtime.h>

namespace tile_counters {
__device__ unsigned long long counts[2];  // tiles executed, DMA blocks

__device__ __forceinline__ void add(unsigned long long tiles,
                                    unsigned long long dma) {
  if (tiles) atomicAdd(&counts[0], tiles);
  if (dma) atomicAdd(&counts[1], dma);
}
}  // namespace tile_counters

// Zero both counters, after every launch queued so far has finished.
extern "C" int tile_counters_reset() {
  cudaDeviceSynchronize();
  const unsigned long long zero[2] = {0, 0};
  cudaMemcpyToSymbol(tile_counters::counts, zero, sizeof(zero));
  return static_cast<int>(cudaGetLastError());
}

// out[0] = tiles executed, out[1] = DMA blocks, once every launch queued so
// far has finished.
extern "C" int tile_counters_read(unsigned long long* out) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, tile_counters::counts,
                       2 * sizeof(unsigned long long));
  return static_cast<int>(cudaGetLastError());
}

#define TC_DECL unsigned long long tc_tiles_ = 0, tc_dma_ = 0
#define TC_TILES(n) (tc_tiles_ += static_cast<unsigned long long>(n))
#define TC_DMA(n) (tc_dma_ += static_cast<unsigned long long>(n))
#define TC_FLUSH(leader)                                \
  do {                                                  \
    if (leader) tile_counters::add(tc_tiles_, tc_dma_); \
  } while (0)
#else
#define TC_DECL static_cast<void>(0)
#define TC_TILES(n) static_cast<void>(0)
#define TC_DMA(n) static_cast<void>(0)
#define TC_FLUSH(leader) static_cast<void>(0)
#endif
