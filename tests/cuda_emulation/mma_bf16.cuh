// The pieces of csrc/mma_bf16.cuh the f32 kernels use, emulated on the CPU:
// copies complete at once (so a buffer overwritten while another thread
// still reads it shows as a wrong result), and a persistent kernel gets two
// SMs' worth of blocks, so that each block walks several tiles.
#pragma once
namespace mma_bf16 {
inline void cp_async16(void* dst, const void* src, bool valid) {
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
      15) {
    std::fprintf(stderr, "cp_async16: a misaligned address\n");
    std::abort();
  }
  if (valid)
    std::memcpy(dst, src, 16);
  else
    std::memset(dst, 0, 16);
}
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
inline void cp_async_wait_one() {}
inline int persistent_blocks(int per_sm, int tiles) {
  return tiles < 2 * per_sm ? tiles : 2 * per_sm;
}
}  // namespace mma_bf16
