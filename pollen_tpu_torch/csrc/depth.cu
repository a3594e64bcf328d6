// Masked segment depth over the resident ELL / crossing-matrix indexes,
// written for Hopper (sm_90a). Four entry points, each one launch that
// reads the raw mask itself; K1 runs K2's tiles on its heavy block, and
// K3 and K9 are K1's tier phase alone, on the tall and the flat layout:
//
//   pollen_ell_tier     one tall tier of ELL slots, 32-bit or pack16, in
//                       ONE launch. Replaces the TPU kernel
//                       pollen_tpu/kernels/ellscan.py _kernel_tall (K3).
//   pollen_cross_depth  masked GEMV over a nibble- or int8-packed
//                       crossing matrix, in one launch. Replaces
//                       pollen_tpu/kernels/crossmat.py _kernel (K2),
//                       depth-only variant included.
//   pollen_ell_splitn   up to three tier phases plus the heavy phase in
//                       ONE launch, no packing launch ahead. Replaces
//                       pollen_tpu/kernels/ellscan.py _kernel_splitn (K1).
//   pollen_ell_flat     1-3 tiers in the flat (K, N_pad) layout of
//                       build_ell, in ONE launch. Replaces
//                       pollen_tpu/kernels/ellscan.py _kernel (K9).
//
// What bounds them on the H100: all four are integer work with about
// one multiply-add per byte read, far below the card's compute roofline,
// so they are bound by memory traffic (and, at the main path's sizes,
// by launch latency: the whole bench-shape index is ~2 MB and sits in
// L2). The design keeps the bytes minimal and the accesses coalesced:
//
//   * K9 (ell_flat_kernel) is K1's tier tile on the flat layout: the
//     tall layout with one group, sub = 1 and a row width and slot
//     stride of N_pad (split_tiles' FLAT), so K1 and K3 compile as they
//     were. A thread owns 4 adjacent columns, each slot word
//     ell[kk * N_pad + c .. c + 3] is one 16-byte load, 1-8 words in
//     flight, and the outputs leave as 16-byte stores; a slot or output
//     base off a 16-byte boundary takes the 4-byte-load instance of the
//     same kernel. The grid is persistent, so a block packs the raw mask
//     into bit words in shared memory once (one ballot a warp, after
//     its first slot loads are issued) for all its tiles, and the tiles
//     of up to three tiers share the one grid: the sharded ELL query
//     launches it once for all its flat tiers. The last tile of a tier
//     is ragged when N_pad % 1024 != 0; a thread's 4 columns are all in
//     or all out (128 % 4 = 0). The TPU gave the flat layout up because
//     its (1, width) stores pad to 8 sublanes; on the GPU it is
//     coalesced as it stands, and at k = 1 it holds the tall layout's
//     bytes in the same order. The TPU kernel's select tournament over
//     scalar mask words has no place here.
//   * K2 (cross_kernel, cross.cuh) is its own design, one launch a call:
//       - Mask: each block reads the raw 0/1 mask itself and compacts the
//         rows with a selected path into a list in shared memory (row,
//         and which of its two nibbles count), so no packing launch runs
//         ahead and unselected rows are never read. The grid is
//         persistent (at most the blocks the card holds at once), so a
//         block builds the list once and walks many column tiles.
//       - Memory-level parallelism: a thread owns 16 columns and reads a
//         row's 16 bytes with one 16-byte load (4-byte loads when the
//         matrix is not 16-byte aligned), 8 list rows in flight at once:
//         a warp streams 512 contiguous bytes a row, and an SM holds
//         ~64 KB of loads in flight, where ~20 KB keep HBM busy.
//       - SIMD lanes: a row's mask is uniform, so it is a byte mask (0 or
//         0x0F0F0F0F per nibble): lo = q & m0, hi = (q >> 4) & m1 hold
//         four columns' counts in byte lanes, added as plain 32-bit
//         words (8 rows of two nibbles <= 15 sum to <= 240 per lane),
//         and (x + 0x0F0F0F0F) & 0x10101010 marks each nonzero nibble
//         for uniq. After each 8 rows the byte lanes are widened into
//         int32 sums (one byte permute each). int8 rows are offset to
//         unsigned (a + 128, and min(a, 1) + 128 = min(a + 128, 129) by
//         __vminu4) and summed in 16-bit lanes; 128 per selected row is
//         taken off at the end, so negative cells match the plain
//         version's clamp too.
//       - Small matrices (the unfused heavy block, 64 x 5376, all in L2)
//         are latency: the 8 warps of a block then split the row list
//         into 2-8 groups over fewer columns (the fewest groups that
//         still give each SM two tiles), so a thread takes one batch of
//         rows, and the groups are summed in shared memory. The call is
//         then two dependent round trips to memory (the mask, then the
//         rows), where a library GEMV needs one; reading every row
//         without the list, its loads issued beside the mask's, was
//         slower on the card (PERF.md).
//     What bounds it: bytes, the matrix read once at 3.35 TB/s; about
//     3-4 integer operations a byte stay under that at the card's
//     integer rate.
//   * K1 (ell_splitn_kernel) is one launch on a persistent grid (at most
//     the blocks the card holds, each walking many tiles), heavy tiles
//     first, so the longest tiles start first:
//       - Heavy tiles are K2's tiles (cross_tile: the selected-row list,
//         16-byte row loads 8 rows in flight, SIMD byte lanes, row groups
//         at small blocks) on the heavy block, and a block stages the row
//         list once for all its heavy tiles.
//       - Tier tiles: a thread owns 4 adjacent columns of a tall row, so
//         each slot word is one 16-byte load (the tall layout is
//         contiguous in c), issued before anything waits on the mask,
//         and the outputs leave as 16-byte stores. On reaching its first
//         tier tile a block packs the raw mask into bit words in shared
//         memory (one ballot a warp, into the heavy tiles' reduction
//         buffer, free by then) and keeps them for all its tier tiles:
//         the mask is read once a block, not once a tile, even at 2^16
//         paths. A slot costs one shared-memory bit lookup.
//     The TPU's joint/sequential grid has no counterpart: tier and heavy
//     tiles are all in flight together on the 132 SMs.
//   * K3 (ell_tier_kernel) is K1's tier phase alone: the same routine
//     (split_tiles with no heavy tiles), in a kernel that holds only
//     the 8 KB of bit words in shared memory, as K9's does (K1's holds
//     ~40 KB for its row list and group sums), so more blocks fit an
//     SM; no packing launch and no scratch. Tier outputs need
//     16-byte-aligned slots and outputs (the wrapper refuses others).

#include "cross.cuh"

namespace {

template <bool NIBBLE>
void launch_cross_u(const CrossArgs& x, bool want_u, bool vec,
                    cudaStream_t st) {
  constexpr int CELLS = NIBBLE ? CELLS_NIBBLE : CELLS_INT8;
  if (want_u) {
    vec ? launch_cross<CELLS, U_SUM, true>(x, st)
        : launch_cross<CELLS, U_SUM, false>(x, st);
  } else {
    vec ? launch_cross<CELLS, U_NONE, true>(x, st)
        : launch_cross<CELLS, U_NONE, false>(x, st);
  }
}

// K1 and K3: see the design notes above.
constexpr int T_COLS = 4;  // tier columns a thread owns
constexpr int T_BLOCK_COLS = THREADS * T_COLS;
constexpr int T_ROW_TILES = TALL_W / T_BLOCK_COLS;  // tier tiles a tall row
constexpr int T_MIN_BLOCKS = 4;  // K3: at most 64 registers a thread

struct SplitArgs {
  Tier t[3];
  int nt;
  int sub;
  int pack16;
  CrossArgs h;      // the heavy block and the raw mask; h.tiles 0 without one
  long long tiles;  // h.tiles heavy tiles, then the tiers' tiles
  long long cols[3];  // K9's flat tiers: columns, each tier's slot stride
};

// Adds W slot words, 4 columns each, into the columns' sums.
template <int W, bool P16>
__device__ __forceinline__ void add_slots(const uint4 (&v)[W],
                                          const int* words, int n_words,
                                          int (&d)[T_COLS], int (&u)[T_COLS]) {
#pragma unroll
  for (int kk = 0; kk < W; ++kk) {
    const unsigned word[T_COLS] = {v[kk].x, v[kk].y, v[kk].z, v[kk].w};
#pragma unroll
    for (int cc = 0; cc < T_COLS; ++cc) {
      if (P16) {
        // Two path<<8|count halves; the low half is the even slot.
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const unsigned h = (word[cc] >> (16 * half)) & 0xFFFFu;
          const int bit = mask_bit(words, n_words, h >> 8);
          d[cc] += bit * (int)(h & 0xFFu);
          u[cc] += bit & (int)(h != 0u);
        }
      } else {
        // path<<16|count; unsigned shifts, so paths >= 2^15 stay positive.
        const int bit = mask_bit(words, n_words, word[cc] >> 16);
        d[cc] += bit * (int)(word[cc] & 0xFFFFu);
        u[cc] += bit & (int)(word[cc] != 0u);
      }
    }
  }
}

// A tall tier tile (K1, K3): 4 columns a thread of tall row `tile_row`
// (g*sub + r), slot words W at a time (the tier's k, or chunks of 8).
// `stage()` returns the mask's bit words, packing them on the block's
// first call: it runs after the first words' loads are issued.
template <int W, bool P16, class Stage>
__device__ __forceinline__ void tier_tile(const Tier& t, int sub,
                                          long long tile_row, int c,
                                          const Stage& stage, int n_words) {
  const long long g = tile_row / sub;
  const int r = (int)(tile_row % sub);
  const long long stride = (long long)sub * TALL_W;  // next slot word
  int d[T_COLS] = {}, u[T_COLS] = {};
  const int* words = nullptr;
  for (int kb = 0; kb < t.k; kb += W) {  // block-uniform
    const int kc = min(W, t.k - kb);
    const int* at = t.slots + ((g * t.k + kb) * sub + r) * TALL_W + c;
    uint4 v[W];
#pragma unroll
    for (int kk = 0; kk < W; ++kk) {
      v[kk] = kk < kc ? __ldg(reinterpret_cast<const uint4*>(at + kk * stride))
                      : make_uint4(0u, 0u, 0u, 0u);
    }
    if (kb == 0) words = stage();
    add_slots<W, P16>(v, words, n_words, d, u);
  }
  const long long n = tile_row * TALL_W + c;
  *reinterpret_cast<int4*>(t.depth + n) = make_int4(d[0], d[1], d[2], d[3]);
  *reinterpret_cast<int4*>(t.uniq + n) = make_int4(u[0], u[1], u[2], u[3]);
}

template <bool P16, class Stage>
__device__ __forceinline__ void tier_tile_k(const Tier& t, int sub,
                                            long long b, const Stage& stage,
                                            int n_words) {
  const long long tile_row = b / T_ROW_TILES;
  const int c = (int)(b % T_ROW_TILES) * T_BLOCK_COLS + threadIdx.x * T_COLS;
  if (t.k <= 1) {
    tier_tile<1, P16>(t, sub, tile_row, c, stage, n_words);
  } else if (t.k <= 2) {
    tier_tile<2, P16>(t, sub, tile_row, c, stage, n_words);
  } else if (t.k <= 4) {
    tier_tile<4, P16>(t, sub, tile_row, c, stage, n_words);
  } else {
    tier_tile<8, P16>(t, sub, tile_row, c, stage, n_words);
  }
}

// A flat tier tile (K9), tile b of 32-bit slots int32[k, cols]: the tall
// tile with one group, sub = 1 and a row width and slot stride of
// `cols`, so columns b * T_BLOCK_COLS on. The last tile is ragged: a
// thread past it (`in` false; cols is a multiple of 128, so a thread's
// 4 columns are all in or all out) loads and stores nothing but still
// takes part in the block's staging. VEC: one 16-byte load a word and
// 16-byte stores, else four 4-byte ones.
template <int W, bool VEC, class Stage>
__device__ __forceinline__ void flat_tile(const Tier& t, long long cols,
                                          long long b, const Stage& stage,
                                          int n_words) {
  const long long c = b * T_BLOCK_COLS + threadIdx.x * T_COLS;
  const bool in = c < cols;
  int d[T_COLS] = {}, u[T_COLS] = {};
  const int* words = nullptr;
  for (int kb = 0; kb < t.k; kb += W) {  // block-uniform
    const int kc = min(W, t.k - kb);
    const int* at = t.slots + kb * cols + c;
    uint4 v[W];
#pragma unroll
    for (int kk = 0; kk < W; ++kk) {
      const int* p = at + kk * cols;
      if (!in || kk >= kc) {
        v[kk] = make_uint4(0u, 0u, 0u, 0u);
      } else if (VEC) {
        v[kk] = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        v[kk] = make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
      }
    }
    if (kb == 0) words = stage();
    add_slots<W, false>(v, words, n_words, d, u);
  }
  if (!in) return;
  if (VEC) {
    *reinterpret_cast<int4*>(t.depth + c) = make_int4(d[0], d[1], d[2], d[3]);
    *reinterpret_cast<int4*>(t.uniq + c) = make_int4(u[0], u[1], u[2], u[3]);
  } else {
#pragma unroll
    for (int cc = 0; cc < T_COLS; ++cc) {
      t.depth[c + cc] = d[cc];
      t.uniq[c + cc] = u[cc];
    }
  }
}

template <bool VEC, class Stage>
__device__ __forceinline__ void flat_tile_k(const Tier& t, long long cols,
                                            long long b, const Stage& stage,
                                            int n_words) {
  if (t.k <= 1) {
    flat_tile<1, VEC>(t, cols, b, stage, n_words);
  } else if (t.k <= 2) {
    flat_tile<2, VEC>(t, cols, b, stage, n_words);
  } else if (t.k <= 4) {
    flat_tile<4, VEC>(t, cols, b, stage, n_words);
  } else {
    flat_tile<8, VEC>(t, cols, b, stage, n_words);
  }
}

// The tiles of a split launch on a persistent grid: heavy tiles first
// (HEAVY only), then the tiers' (tall, or FLAT). `s_red` holds the heavy
// tiles' group sums (2 * X_BLOCK_COLS ints; `s_list` and `s_count` their
// row list) and, once a block reaches its tier tiles (they come after
// every heavy tile), the mask's bit words (MAX_SMEM_WORDS ints). VEC:
// 16-byte loads of the heavy block (K1) or of the flat tiers (K9); tall
// tiers are always 16-byte aligned. Every thread of the block calls it.
template <bool VEC, bool HEAVY, bool FLAT>
__device__ __forceinline__ void split_tiles(const SplitArgs& x, int* s_list,
                                            int* s_count, int* s_red) {
  const CrossArgs& h = x.h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Slots hold 16-bit path ids: words past 2^16 paths are never read.
  const int n_words = min((h.n_paths + 31) / 32, MAX_SMEM_WORDS);
  int n_sel = -1;  // the row list is not staged yet
  const int* words = nullptr;
  const auto stage = [&]() -> const int* {
    if (words == nullptr) {  // block-uniform
      constexpr int WARPS = THREADS / 32;
      constexpr int BATCH = 8;  // words a warp loads before its ballots
      for (int w0 = warp; w0 < n_words; w0 += WARPS * BATCH) {
        int bit[BATCH];
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          const long long p = 32LL * (w0 + i * WARPS) + lane;
          bit[i] = raw_mask_bit(h.mask, h.elem_bytes, h.n_paths, p);
        }
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          const unsigned b = __ballot_sync(0xFFFFFFFFu, bit[i]);
          const int wi = w0 + i * WARPS;
          if (lane == 0 && wi < n_words) s_red[wi] = (int)b;
        }
      }
      __syncthreads();
      words = s_red;
    }
    return words;
  };
  for (long long tile = blockIdx.x; tile < x.tiles; tile += gridDim.x) {
    if constexpr (HEAVY) {
      if (tile < h.tiles) {
        if (n_sel < 0) {
          n_sel = h.rows <= X_ROW_CHUNK
                      ? stage_rows<true>(h, 0, h.rows, s_list, s_count)
                      : 0;
        }
        cross_tile<CELLS_NIBBLE, U_SUM, VEC>(
            h, (int)tile, n_sel, s_list, s_count,
            reinterpret_cast<int (*)[X_BLOCK_COLS]>(s_red));
        continue;
      }
    }
    long long b = tile - h.tiles;
    for (int i = 0; i < x.nt; ++i) {
      const long long nb =
          FLAT ? (x.cols[i] + T_BLOCK_COLS - 1) / T_BLOCK_COLS
               : (long long)x.t[i].g * x.sub * T_ROW_TILES;
      if (b < nb) {
        if constexpr (FLAT) {
          flat_tile_k<VEC>(x.t[i], x.cols[i], b, stage, n_words);
        } else if (x.pack16) {
          tier_tile_k<true>(x.t[i], x.sub, b, stage, n_words);
        } else {
          tier_tile_k<false>(x.t[i], x.sub, b, stage, n_words);
        }
        break;
      }
      b -= nb;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, X_MIN_BLOCKS)
    ell_splitn_kernel(SplitArgs x) {
  __shared__ int s_list[X_ROW_CHUNK];
  __shared__ int s_count;
  __shared__ __align__(16) int s_red[2][X_BLOCK_COLS];
  static_assert(MAX_SMEM_WORDS <= 2 * X_BLOCK_COLS, "bit words fit s_red");
  split_tiles<VEC, true, false>(x, s_list, &s_count, &s_red[0][0]);
}

__global__ void __launch_bounds__(THREADS, T_MIN_BLOCKS)
    ell_tier_kernel(SplitArgs x) {
  __shared__ int s_words[MAX_SMEM_WORDS];
  split_tiles<true, false, false>(x, nullptr, nullptr, s_words);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, T_MIN_BLOCKS)
    ell_flat_kernel(SplitArgs x) {
  __shared__ int s_words[MAX_SMEM_WORDS];
  split_tiles<VEC, false, true>(x, nullptr, nullptr, s_words);
}

// One launch of K1 (HEAVY), K3 or K9 (FLAT) on a persistent grid, as
// launch_cross.
template <bool VEC, bool HEAVY, bool FLAT = false>
void launch_splitn(const SplitArgs& x, cudaStream_t st) {
  static int resident = 0;
  if (resident == 0) {
    int per_sm = 0;
    if constexpr (HEAVY) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ell_splitn_kernel<VEC>, THREADS, 0);
    } else if constexpr (FLAT) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ell_flat_kernel<VEC>, THREADS, 0);
    } else {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ell_tier_kernel,
                                                    THREADS, 0);
    }
    resident = sm_count() * (per_sm > 0 ? per_sm : 1);
  }
  const unsigned blocks = (unsigned)(x.tiles < resident ? x.tiles : resident);
  if constexpr (HEAVY) {
    ell_splitn_kernel<VEC><<<blocks, THREADS, 0, st>>>(x);
  } else if constexpr (FLAT) {
    ell_flat_kernel<VEC><<<blocks, THREADS, 0, st>>>(x);
  } else {
    ell_tier_kernel<<<blocks, THREADS, 0, st>>>(x);
  }
}

Tier tier_of(const void* slots, int k, int g, void* depth, void* uniq) {
  return {static_cast<const int*>(slots), k, g, static_cast<int*>(depth),
          static_cast<int*>(uniq)};
}

// The raw mask and no heavy block.
CrossArgs mask_only(const void* mask, int elem_bytes, int n_paths) {
  return {nullptr, 0, 0, mask, elem_bytes, n_paths, nullptr, nullptr, 1, 0,
          nullptr};
}

}  // namespace

extern "C" {

// K1, K2, K3 and K9 take the raw mask (`elem_bytes` 1 or 4 per path)
// and no scratch: each block packs its own bit words.

// K3: tier slots and outputs 16-byte aligned.
int pollen_ell_tier(const void* slots, int k, int g, int sub, int pack16,
                    const void* mask, int elem_bytes, int n_paths,
                    void* depth, void* uniq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((reinterpret_cast<uintptr_t>(slots) | reinterpret_cast<uintptr_t>(depth) |
       reinterpret_cast<uintptr_t>(uniq)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  SplitArgs x{{tier_of(slots, k, g, depth, uniq)},
              1, sub, pack16, mask_only(mask, elem_bytes, n_paths),
              (long long)g * sub * T_ROW_TILES};
  if (x.tiles > 0) launch_splitn<true, false>(x, st);
  return (int)cudaGetLastError();
}

// K2 takes the raw mask itself (no bit words). `a` is 4-byte aligned
// (16-byte aligned for the 16-byte loads), `depth` and `uniq` 16-byte
// aligned; `uniq` null runs the depth-only variant.
int pollen_cross_depth(const void* a, int rows, long long n_pad, int nibble,
                       const void* mask, int elem_bytes, int n_paths,
                       void* depth, void* uniq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_pad % H_COLS || reinterpret_cast<uintptr_t>(a) % 4 ||
      (reinterpret_cast<uintptr_t>(depth) |
       reinterpret_cast<uintptr_t>(uniq)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_pad <= 0) return (int)cudaGetLastError();
  CrossArgs x{static_cast<const uint8_t*>(a), rows, n_pad, mask, elem_bytes,
              n_paths, static_cast<int*>(depth), static_cast<int*>(uniq),
              1, 0, nullptr};
  plan_cross(x);
  const bool vec = reinterpret_cast<uintptr_t>(a) % 16 == 0;
  if (nibble) {
    launch_cross_u<true>(x, uniq != nullptr, vec, st);
  } else {
    launch_cross_u<false>(x, uniq != nullptr, vec, st);
  }
  return (int)cudaGetLastError();
}

// K1 takes the raw mask itself (no bit words). Tier slots and outputs
// are 16-byte aligned; the heavy block (nibbles, null when absent) is
// 4-byte aligned with a multiple of 128 columns.
int pollen_ell_splitn(int nt,
                      const void* s0, int k0, int g0, void* d0, void* u0,
                      const void* s1, int k1, int g1, void* d1, void* u1,
                      const void* s2, int k2, int g2, void* d2, void* u2,
                      const void* heavy, int h_rows, int nh_pad, void* dh,
                      void* uh, int sub, int pack16, const void* mask,
                      int elem_bytes, int n_paths, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SplitArgs x{{tier_of(s0, k0, g0, d0, u0), tier_of(s1, k1, g1, d1, u1),
               tier_of(s2, k2, g2, d2, u2)},
              nt, sub, pack16, mask_only(mask, elem_bytes, n_paths), 0};
  uintptr_t align = 0;
  for (int i = 0; i < nt; ++i) {
    align |= reinterpret_cast<uintptr_t>(x.t[i].slots) |
             reinterpret_cast<uintptr_t>(x.t[i].depth) |
             reinterpret_cast<uintptr_t>(x.t[i].uniq);
    x.tiles += (long long)x.t[i].g * sub * T_ROW_TILES;
  }
  if (heavy != nullptr) {
    if (nh_pad % H_COLS || reinterpret_cast<uintptr_t>(heavy) % 4) {
      return (int)cudaErrorInvalidValue;
    }
    align |= reinterpret_cast<uintptr_t>(dh) | reinterpret_cast<uintptr_t>(uh);
    x.h.a = static_cast<const uint8_t*>(heavy);
    x.h.rows = h_rows;
    x.h.n_pad = nh_pad;
    x.h.depth = static_cast<int*>(dh);
    x.h.uniq = static_cast<int*>(uh);
    plan_cross(x.h);
    x.tiles += x.h.tiles;
  }
  if (align % 16) return (int)cudaErrorInvalidValue;
  if (x.tiles == 0) return (int)cudaGetLastError();
  if (heavy == nullptr || reinterpret_cast<uintptr_t>(heavy) % 16 == 0) {
    launch_splitn<true, true>(x, st);
  } else {
    launch_splitn<false, true>(x, st);
  }
  return (int)cudaGetLastError();
}

// K9: 1-3 flat tiers, slots int32[k, cols] with cols a multiple of 128,
// all pointers 4-byte aligned (16-byte ones take 16-byte loads).
int pollen_ell_flat(int nt,
                    const void* s0, int k0, long long n0, void* d0, void* u0,
                    const void* s1, int k1, long long n1, void* d1, void* u1,
                    const void* s2, int k2, long long n2, void* d2, void* u2,
                    const void* mask, int elem_bytes, int n_paths,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nt < 1 || nt > 3) return (int)cudaErrorInvalidValue;
  SplitArgs x{{tier_of(s0, k0, 1, d0, u0), tier_of(s1, k1, 1, d1, u1),
               tier_of(s2, k2, 1, d2, u2)},
              nt, 1, 0, mask_only(mask, elem_bytes, n_paths), 0,
              {n0, n1, n2}};
  uintptr_t align = 0;
  for (int i = 0; i < nt; ++i) {
    if (x.cols[i] % H_COLS) return (int)cudaErrorInvalidValue;
    align |= reinterpret_cast<uintptr_t>(x.t[i].slots) |
             reinterpret_cast<uintptr_t>(x.t[i].depth) |
             reinterpret_cast<uintptr_t>(x.t[i].uniq);
    x.tiles += (x.cols[i] + T_BLOCK_COLS - 1) / T_BLOCK_COLS;
  }
  if (align % 4) return (int)cudaErrorInvalidValue;
  if (x.tiles == 0) return (int)cudaGetLastError();
  if (align % 16 == 0) {
    launch_splitn<true, false, true>(x, st);
  } else {
    launch_splitn<false, false, true>(x, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
