// Masked segment depth over the resident ELL / crossing-matrix indexes,
// written for Hopper (sm_90a). Four entry points share the mask packing
// and two device functions:
//
//   pollen_ell_tier     one tall tier of ELL slots. Replaces the TPU
//                       kernel pollen_tpu/kernels/ellscan.py _kernel_tall
//                       (K3), and also reads pack16 paired slots.
//   pollen_cross_depth  masked GEMV over a nibble- or int8-packed
//                       crossing matrix. Replaces pollen_tpu/kernels/
//                       crossmat.py _kernel (K2), depth-only variant
//                       included.
//   pollen_ell_splitn   up to three tier phases plus the heavy phase in
//                       ONE launch. Replaces pollen_tpu/kernels/
//                       ellscan.py _kernel_splitn (K1).
//   pollen_ell_flat     one tier in the flat (K, N_pad) layout of
//                       build_ell. Replaces pollen_tpu/kernels/ellscan.py
//                       _kernel (K9).
//
// What bounds them on the H100: all four are integer work with about
// one multiply-add per byte read, far below the card's compute roofline,
// so they are bound by memory traffic (and, at the main path's sizes,
// by launch latency: the whole bench-shape index is ~2 MB and sits in
// L2). The design keeps the bytes minimal and the accesses coalesced:
//
//   * The query mask is packed into bit words (path p -> bit p%32 of
//     word p/32) by a one-ballot-per-warp launch ahead of the kernel, so
//     the caller hands over the raw 0/1 mask and pays one host call.
//     Each block stages the words in shared memory (8 KB at 2^16 paths)
//     and looks a path's bit up directly. The TPU kernel's select
//     tournament over scalar words has no place here.
//   * Tier function: one thread per output column. A thread reads its
//     K slot words at tall[(g*K + kk)*SUB + r, c]: neighbouring threads
//     read neighbouring words, so every load is one coalesced 128-byte
//     line per warp, and each slot word is read exactly once. Output
//     column (g*SUB + r)*4096 + c is the natural column order, so no
//     unfold pass is needed.
//   * Flat tier: one thread per column, its K slot words read down the
//     column at ell[kk * n_pad + c], so each warp's load is one 128-byte
//     line and every word is read once; outputs need no reordering. The
//     TPU gave this layout up because its (1, width) stores pad to 8
//     sublanes; on the GPU it is coalesced as it stands. Any n_pad works
//     (the last block masks its ragged edge).
//   * Heavy function: byte row r holds path 2r in its low nibble and
//     path 2r+1 in its high nibble (int8 layout: row = path). A block
//     covers 128 columns; each thread reads 4 columns as one 32-bit
//     word and walks every 8th row, and the 8 row groups are summed in
//     shared memory. The row loop is warp-uniform, so rows whose paths
//     are all unselected are skipped without divergence and their bytes
//     are never read. Sums are exact int32 (no bf16 detour).
//   * The fused launch replaces the TPU's joint/sequential grid: blocks
//     [0, tier blocks) run the tier phases, the blocks after them the
//     heavy phase, all in flight together on the 132 SMs.

#include "common.cuh"

namespace {

// One tier: block `blk` of the tier's g*sub*COL_BLOCKS blocks.
__device__ __forceinline__ void tier_column(
    const Tier& t, int sub, int pack16, const int* words, int n_words,
    long long blk) {
  const long long tile_row = blk / COL_BLOCKS;  // g*sub + r
  const int c = (int)(blk % COL_BLOCKS) * THREADS + threadIdx.x;
  const long long g = tile_row / sub;
  const int r = (int)(tile_row % sub);
  int d = 0;
  int u = 0;
  for (int kk = 0; kk < t.k; ++kk) {
    const long long row = (g * t.k + kk) * sub + r;
    const unsigned v = (unsigned)__ldg(t.slots + row * TALL_W + c);
    if (pack16) {
      // Two path<<8|count halves; the low half is the even slot.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const unsigned h = (v >> (16 * half)) & 0xFFFFu;
        const int bit = mask_bit(words, n_words, (h >> 8) & 0xFFu);
        d += bit * (int)(h & 0xFFu);
        u += bit & (int)(h != 0u);
      }
    } else {
      // path<<16|count; unsigned shifts, so paths >= 2^15 stay positive.
      const int bit = mask_bit(words, n_words, (v >> 16) & 0xFFFFu);
      d += bit * (int)(v & 0xFFFFu);
      u += bit & (int)(v != 0u);
    }
  }
  const long long n = tile_row * TALL_W + c;
  t.depth[n] = d;
  t.uniq[n] = u;
}

// Heavy / dense block: 128 columns starting at blk*128. `uniq` may be
// null (depth only).
__device__ __forceinline__ void heavy_columns(
    const uint8_t* __restrict__ a, int rows, int n_pad, int nibble,
    const int* words, int n_words, long long blk, int* depth, int* uniq,
    int (*s_d)[H_COLS], int (*s_u)[H_COLS]) {
  const int lane = threadIdx.x & 31;
  const int grp = threadIdx.x >> 5;
  const long long col0 = blk * H_COLS;
  const long long col = col0 + lane * 4;
  const bool want_u = uniq != nullptr;
  int d[4] = {0, 0, 0, 0};
  int u[4] = {0, 0, 0, 0};
  for (int r = grp; r < rows; r += H_GROUPS) {
    const int m0 = mask_bit(words, n_words, nibble ? 2u * r : (unsigned)r);
    const int m1 = nibble ? mask_bit(words, n_words, 2u * r + 1u) : 0;
    if (!(m0 | m1)) continue;  // warp-uniform: every lane has this r
    const unsigned q = __ldg(reinterpret_cast<const unsigned*>(
        a + (long long)r * n_pad + col));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned b = (q >> (8 * j)) & 0xFFu;
      if (nibble) {
        const int lo = (int)(b & 15u);
        const int hi = (int)(b >> 4);
        d[j] += m0 * lo + m1 * hi;
        if (want_u) u[j] += (m0 & (int)(lo != 0)) + (m1 & (int)(hi != 0));
      } else {
        const int v = (int)(int8_t)b;
        d[j] += m0 * v;
        if (want_u) u[j] += m0 & (int)(v != 0);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s_d[grp][lane * 4 + j] = d[j];
    s_u[grp][lane * 4 + j] = u[j];
  }
  __syncthreads();
  if (threadIdx.x < H_COLS) {
    int sd = 0;
    int su = 0;
#pragma unroll
    for (int gi = 0; gi < H_GROUPS; ++gi) {
      sd += s_d[gi][threadIdx.x];
      su += s_u[gi][threadIdx.x];
    }
    depth[col0 + threadIdx.x] = sd;
    if (want_u) uniq[col0 + threadIdx.x] = su;
  }
}

__global__ void __launch_bounds__(THREADS) ell_tier_kernel(
    Tier t, int sub, int pack16, const int* words, int n_words) {
  __shared__ int s_words[MAX_SMEM_WORDS];
  const int* w = stage_words(s_words, words, n_words, MAX_SMEM_WORDS);
  tier_column(t, sub, pack16, w, n_words, blockIdx.x);
}

__global__ void __launch_bounds__(THREADS) cross_kernel(
    const uint8_t* a, int rows, int n_pad, int nibble, const int* words,
    int n_words, int* depth, int* uniq) {
  __shared__ int s_words[MAX_SMEM_WORDS];
  __shared__ int s_d[H_GROUPS][H_COLS];
  __shared__ int s_u[H_GROUPS][H_COLS];
  const int* w = stage_words(s_words, words, n_words, MAX_SMEM_WORDS);
  heavy_columns(a, rows, n_pad, nibble, w, n_words, blockIdx.x, depth,
                uniq, s_d, s_u);
}

// Flat tier: column blockIdx.x * THREADS + threadIdx.x of ell[k, n_pad].
__global__ void __launch_bounds__(THREADS) ell_flat_kernel(
    const int* __restrict__ ell, int k, long long n_pad, const int* words,
    int n_words, int* depth, int* uniq) {
  __shared__ int s_words[MAX_SMEM_WORDS];
  const int* w = stage_words(s_words, words, n_words, MAX_SMEM_WORDS);
  const long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (c >= n_pad) return;  // after every thread has staged the mask
  int d = 0;
  int u = 0;
  for (int kk = 0; kk < k; ++kk) {
    const unsigned v = (unsigned)__ldg(ell + (long long)kk * n_pad + c);
    // path<<16|count; unsigned shifts, so paths >= 2^15 stay positive.
    const int bit = mask_bit(w, n_words, (v >> 16) & 0xFFFFu);
    d += bit * (int)(v & 0xFFFFu);
    u += bit & (int)(v != 0u);
  }
  depth[c] = d;
  uniq[c] = u;
}

__global__ void __launch_bounds__(THREADS) ell_splitn_kernel(
    Tier t0, Tier t1, Tier t2, int nt, const uint8_t* heavy, int h_rows,
    int nh_pad, int* dh, int* uh, int sub, int pack16, const int* words,
    int n_words) {
  __shared__ int s_words[MAX_SMEM_WORDS];
  __shared__ int s_d[H_GROUPS][H_COLS];
  __shared__ int s_u[H_GROUPS][H_COLS];
  const int* w = stage_words(s_words, words, n_words, MAX_SMEM_WORDS);
  long long b = blockIdx.x;  // block-uniform: no divergent phase picks
  const Tier* tiers[3] = {&t0, &t1, &t2};
  for (int i = 0; i < nt; ++i) {
    const long long nb = (long long)tiers[i]->g * sub * COL_BLOCKS;
    if (b < nb) {
      tier_column(*tiers[i], sub, pack16, w, n_words, b);
      return;
    }
    b -= nb;
  }
  heavy_columns(heavy, h_rows, nh_pad, 1, w, n_words, b, dh, uh, s_d,
                s_u);
}

}  // namespace

extern "C" {

// Every entry point takes the raw mask (`elem_bytes` 1 or 4 per path)
// and a scratch buffer of n_words int32 for its bit words.

int pollen_ell_tier(const void* slots, int k, int g, int sub, int pack16,
                    const void* mask, int elem_bytes, int n_paths,
                    void* words, int n_words, void* depth, void* uniq,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(words);
  pack_mask(mask, elem_bytes, n_paths, 1, w, n_words, st);
  Tier t{static_cast<const int*>(slots), k, g, static_cast<int*>(depth),
         static_cast<int*>(uniq)};
  const long long blocks = (long long)g * sub * COL_BLOCKS;
  if (blocks > 0) {
    ell_tier_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(t, sub, pack16, w,
                                                          n_words);
  }
  return (int)cudaGetLastError();
}

int pollen_cross_depth(const void* a, int rows, int n_pad, int nibble,
                       const void* mask, int elem_bytes, int n_paths,
                       void* words, int n_words, void* depth, void* uniq,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(words);
  pack_mask(mask, elem_bytes, n_paths, 1, w, n_words, st);
  const long long blocks = n_pad / H_COLS;
  if (blocks > 0) {
    cross_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<const uint8_t*>(a), rows, n_pad, nibble, w, n_words,
        static_cast<int*>(depth), static_cast<int*>(uniq));
  }
  return (int)cudaGetLastError();
}

int pollen_ell_splitn(int nt,
                      const void* s0, int k0, int g0, void* d0, void* u0,
                      const void* s1, int k1, int g1, void* d1, void* u1,
                      const void* s2, int k2, int g2, void* d2, void* u2,
                      const void* heavy, int h_rows, int nh_pad, void* dh,
                      void* uh, int sub, int pack16, const void* mask,
                      int elem_bytes, int n_paths, void* words, int n_words,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(words);
  pack_mask(mask, elem_bytes, n_paths, 1, w, n_words, st);
  Tier t[3] = {
      {static_cast<const int*>(s0), k0, g0, static_cast<int*>(d0),
       static_cast<int*>(u0)},
      {static_cast<const int*>(s1), k1, g1, static_cast<int*>(d1),
       static_cast<int*>(u1)},
      {static_cast<const int*>(s2), k2, g2, static_cast<int*>(d2),
       static_cast<int*>(u2)},
  };
  long long blocks = 0;
  for (int i = 0; i < nt; ++i) blocks += (long long)t[i].g * sub * COL_BLOCKS;
  if (heavy != nullptr) blocks += nh_pad / H_COLS;
  if (blocks > 0) {
    ell_splitn_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
        t[0], t[1], t[2], nt, static_cast<const uint8_t*>(heavy), h_rows,
        nh_pad, static_cast<int*>(dh), static_cast<int*>(uh), sub, pack16, w,
        n_words);
  }
  return (int)cudaGetLastError();
}

int pollen_ell_flat(const void* ell, int k, long long n_pad,
                    const void* mask, int elem_bytes, int n_paths,
                    void* words, int n_words, void* depth, void* uniq,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(words);
  pack_mask(mask, elem_bytes, n_paths, 1, w, n_words, st);
  const long long blocks = (n_pad + THREADS - 1) / THREADS;
  if (blocks > 0) {
    ell_flat_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<const int*>(ell), k, n_pad, w, n_words,
        static_cast<int*>(depth), static_cast<int*>(uniq));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
