// Shared by the dependent-chain kernels, K9 (cleanup.cu), K11 (binpack.cu)
// and K12 (greedy.cu): one block walks a chain of steps, each depending on
// the state the one before left, while producer warps stage the inputs
// that do not depend on the chain into a ring of shared-memory slots ahead
// of it. The primitives below are the ring's handshakes: mbarriers with
// bulk copies (TMA) completing on them, and acquire / release flags in
// shared memory; plus the named barrier the consumer warps step on without
// the producers, and the warp-wide bitonic sort the producers order their
// keys with.

#pragma once

#include <stdint.h>

namespace {

// the shared memory a block may take on an H100 (opt-in, dynamic)
constexpr int kSmemMax = 232448;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// --- mbarriers (one thread initialises; fence before any other use)
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// arrive, and expect `bytes` more of asynchronous copies before the phase ends
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// TMA bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from device to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// --- flags in shared memory
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(smem_addr(p)), "r"(v) : "memory");
}

// a read of a word in shared memory another warp may be clearing bits of
// (stale is safe where bits only ever clear; an acquire before it orders
// it after what that acquire saw): a plain shared load, issued afresh each
// time (a volatile or relaxed load of the word costs hundreds of cycles a
// read on an H100)
__device__ __forceinline__ uint32_t ld_word(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)));
  return v;
}

// --- the barrier of the first `threads` threads of the block (barrier 1;
// __syncthreads is barrier 0)
__device__ __forceinline__ void named_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

__device__ __forceinline__ void nap(unsigned ns) { __nanosleep(ns); }

// ascending bitonic sort of the warp's 32 x NJ keys, element lane * NJ + j
// in key[j]: u64 keys, or floats (none NaN; +0 and -0 in either order)
template <int NJ, class K>
__device__ __forceinline__ void warp_sort(K (&key)[NJ], int lane) {
  constexpr int N = 32 * NJ;
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= NJ) {  // the partner is in lane ^ (stride / NJ), same j
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int e = lane * NJ + j;
          const K o = __shfl_xor_sync(0xffffffffu, key[j], stride / NJ);
          const bool up = (e & size) == 0;
          const bool lower = (e & stride) == 0;
          const K lo_k = o < key[j] ? o : key[j];
          const K hi_k = o < key[j] ? key[j] : o;
          key[j] = lower == up ? lo_k : hi_k;
        }
      } else {  // the partner is this lane's j ^ stride
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j & stride) continue;
          const int e = lane * NJ + j;
          const bool up = (e & size) == 0;
          const K a = key[j], b = key[j | stride];
          if ((b < a) == up) {
            key[j] = b;
            key[j | stride] = a;
          }
        }
      }
    }
  }
}

}  // namespace
