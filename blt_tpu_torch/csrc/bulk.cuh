// Hopper's bulk asynchronous copies (cp.async.bulk, the TMA engine without a
// tensor map, and cp.async.bulk.tensor through one) and the mbarriers they
// complete on, for one issuing thread. Shared by onehot_mma.cu (T14 stages
// its planes), chain.cu (the copy's ring) and subgather.cu (T9's slabs). Shared-memory operands are 32-bit shared-window addresses
// (__cvta_generic_to_shared); every address and size is a multiple of 16.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// An mbarrier with one arrival per phase: the thread that sets its
// transaction bytes (stage).
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One thread: the current phase of bar completes once `bytes` more bytes
// have arrived (this is the phase's one arrival).
__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// One thread: `bytes` from global src into shared memory at dst, as bulk
// copies of at most `piece` bytes, completing the current phase of bar.
__device__ __forceinline__ void stage(uint32_t dst, const uint8_t* src, uint32_t bytes,
                                      uint32_t piece, uint32_t bar) {
  expect_bytes(bar, bytes);
  for (uint32_t o = 0; o < bytes; o += piece) {
    const uint32_t len = bytes - o < piece ? bytes - o : piece;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(dst + o),
        "l"(src + o), "r"(len), "r"(bar)
        : "memory");
  }
}

// One thread: the box of the 2D tensor map `map` (a __grid_constant__
// parameter) whose first element is at column x, row y, into shared memory
// at dst (rows of the box one after another), completing on bar. Elements
// past the tensor's edge arrive as zeros and count as bytes.
__device__ __forceinline__ void tensor_load_2d(uint32_t dst, const void* map, int x, int y,
                                               uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// Waits for the phase of bar with this parity to complete; a copy that never
// completes ends the kernel with a fault after 2**26 tries, never a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One thread: `bytes` from shared memory at src to global dst, as one bulk
// copy in a new bulk group.
__device__ __forceinline__ void bulk_store(uint8_t* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's newest bulk groups still read
// their shared memory: the older ones' sources may be overwritten.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until every bulk group of this thread has completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace
