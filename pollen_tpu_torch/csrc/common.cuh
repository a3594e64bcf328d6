// Pieces shared by the kernel sources of csrc/: layout constants, the
// mask-bit lookup and the launch that packs 0/1 path masks into bit
// words. Everything is in an anonymous namespace, so each source that
// includes this header gets its own copy (no device linking needed).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TALL_W = 4096;   // tall-layout width (ellscan.py TALL_W)
constexpr int THREADS = 256;   // threads per block, every kernel
constexpr int COL_BLOCKS = TALL_W / THREADS;  // tier blocks per tall row
constexpr int H_COLS = 128;    // heavy columns per block (32 lanes x 4)
constexpr int H_GROUPS = THREADS / 32;  // warps per block
constexpr int MAX_SMEM_WORDS = 2048;    // 2^16 paths of mask bits

struct Tier {
  const int* slots;  // int32[g*k*sub, TALL_W] tall slots
  int k;             // stored words per column
  int g;             // tall row groups
  int* depth;        // int32[(q,) g*sub*TALL_W]
  int* uniq;         // int32[(q,) g*sub*TALL_W]
};

// Stage `count` mask words in shared memory when they fit in `cap`;
// beyond that they stay in global memory (read through L1). Returns the
// pointer to read from. Every thread of the block must call it.
__device__ __forceinline__ const int* stage_words(
    int* s_words, const int* words, int count, int cap) {
  if (count > cap) return words;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    s_words[i] = words[i];
  }
  __syncthreads();
  return s_words;
}

__device__ __forceinline__ int mask_bit(
    const int* words, int n_words, unsigned pid) {
  unsigned w = pid >> 5;
  if (w >= (unsigned)n_words) return 0;
  return (int)(((unsigned)words[w] >> (pid & 31u)) & 1u);
}

// Rows of 0/1 path masks (one byte or one int32 per path, `n_paths` per
// row, row blockIdx.y) -> rows of n_words bit words, one ballot per
// warp. Launched ahead of each kernel on the same stream, so a query
// hands the raw masks over and packs them in one launch.
__global__ void __launch_bounds__(THREADS) pack_mask_kernel(
    const void* mask, int elem_bytes, int n_paths, int* words,
    int n_words) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const long long row = blockIdx.y;
  int bit = 0;
  if (i < n_paths) {
    const long long at = row * n_paths + i;
    bit = elem_bytes == 4 ? static_cast<const int*>(mask)[at] != 0
                          : static_cast<const uint8_t*>(mask)[at] != 0;
  }
  const unsigned w = __ballot_sync(0xFFFFFFFFu, bit);
  if ((threadIdx.x & 31) == 0 && (i >> 5) < n_words) {
    words[row * n_words + (i >> 5)] = (int)w;
  }
}

// Packs `rows` masks into `words` (n_words = max(ceil(n_paths / 32), 1)
// per row).
void pack_mask(const void* mask, int elem_bytes, int n_paths, int rows,
               int* words, int n_words, cudaStream_t stream) {
  const dim3 grid((n_words * 32 + THREADS - 1) / THREADS, rows);
  pack_mask_kernel<<<grid, THREADS, 0, stream>>>(mask, elem_bytes, n_paths,
                                                 words, n_words);
}

}  // namespace
