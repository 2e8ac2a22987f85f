// The bit transpose K13 (sinkhorn.cu) and K14's feasibility launch
// (blocked.cu) turn one orientation of a 32 x 32 mask tile into the other
// with.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The 32 x 32 bit matrix a warp holds a row a lane (bit j of lane l's
// word: entry (l, j)), transposed: lane l gets column l. Each stage swaps
// the off-diagonal s x s blocks of every 2s x 2s block.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t lo[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu, 0x33333333u, 0x55555555u};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int s = 16 >> k;
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, s);
    x = (lane & s) ? (x & ~lo[k]) | ((y >> s) & lo[k]) : (x & lo[k]) | ((y & lo[k]) << s);
  }
  return x;
}

}  // namespace
