// cache_slot_update: write row b's update into its cache at one slot, in place:
//
//   cache[b, min(slot_b, S - 1)] = update[b]        (slot_b < 0: no write)
//
// for a batch of caches (B, S, KV, hd) in float32 or bfloat16, with one slot
// per row or one slot for every row.
//
// Replaces the Pallas kernel src/repro/kernels/cache_update.py::cache_slot_update
// (_cache_update_kernel, pl.pallas_call at cache_update.py:69), whose grid runs
// over 128-row blocks of one (S, KV, hd) cache and touches only the block that
// holds the slot (@pl.when), with the cache aliased to the output.
//
// Bound on the H100: bytes, and below them the launch. Each row reads its
// (KV, hd) update and writes the same bytes once (81,920 bytes in all for
// zamba2-2.7b's decode: B = 4, KV = 32, hd = 80, float32), microseconds below
// the launch latency.
//
// Design: one block per row. The block reads its slot (from the slot array or
// the scalar), clamps it like the Pallas kernel, and copies the row's bytes
// with 16-byte vectors when the row length and both base pointers allow it,
// else 4- or 2-byte words. No other byte of the cache is read or written, so
// S needs no rounding (128 was the TPU's tiling), and the dtype only fixes
// the row's byte length.
#include <stdint.h>

#include "l2s_common.cuh"

#define CU_THREADS 256

template <typename Word>
__device__ __forceinline__ void cu_copy(char* __restrict__ dst,
                                        const char* __restrict__ src, int row_bytes) {
  Word* d = reinterpret_cast<Word*>(dst);
  const Word* s = reinterpret_cast<const Word*>(src);
  const int n = row_bytes / (int)sizeof(Word);
  for (int i = threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
}

__global__ void __launch_bounds__(CU_THREADS)
cache_slot_update_kernel(char* __restrict__ cache, const char* __restrict__ update,
                         const int* __restrict__ slots, int slot, int S,
                         int row_bytes, int word) {
  const int b = blockIdx.x;
  int s = slots ? slots[b] : slot;
  if (s < 0) return;            // no 128-row block of the Pallas grid holds it
  if (s > S - 1) s = S - 1;     // clamp like dynamic_update_slice
  char* dst = cache + ((size_t)b * S + s) * row_bytes;
  const char* src = update + (size_t)b * row_bytes;
  if (word == 16)
    cu_copy<uint4>(dst, src, row_bytes);
  else if (word == 4)
    cu_copy<uint32_t>(dst, src, row_bytes);
  else
    cu_copy<uint16_t>(dst, src, row_bytes);
}

// cache (B, S, row) and update (B, row), row = KV * hd elements of row_bytes
// bytes in all (float32 or bfloat16), contiguous on one device. slots: (B,)
// int32 on the device, or null to use `slot` for every row. Returns a
// cudaError_t (0 on success).
extern "C" int l2s_cache_slot_update(void* cache, const void* update, const int* slots,
                                     int slot, int B, int S, int row_bytes,
                                     void* stream) {
  if (B <= 0 || row_bytes <= 0) return (int)cudaSuccess;
  if (S <= 0 || row_bytes % 2) return (int)cudaErrorInvalidValue;
  const uintptr_t addr = (uintptr_t)cache | (uintptr_t)update;
  int word = 2;
  if (row_bytes % 16 == 0 && addr % 16 == 0)
    word = 16;
  else if (row_bytes % 4 == 0 && addr % 4 == 0)
    word = 4;
  cache_slot_update_kernel<<<B, CU_THREADS, 0, (cudaStream_t)stream>>>(
      (char*)cache, (const char*)update, slots, slot, S, row_bytes, word);
  return (int)cudaGetLastError();
}
