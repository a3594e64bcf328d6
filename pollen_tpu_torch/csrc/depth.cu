// Masked segment depth over the resident ELL / crossing-matrix indexes,
// written for Hopper (sm_90a). Four entry points; K1, K3 and K9 read
// mask bit words packed ahead of them, K1 and K3 share the tier
// function, and K2 has its own kernel:
//
//   pollen_ell_tier     one tall tier of ELL slots. Replaces the TPU
//                       kernel pollen_tpu/kernels/ellscan.py _kernel_tall
//                       (K3), and also reads pack16 paired slots.
//   pollen_cross_depth  masked GEMV over a nibble- or int8-packed
//                       crossing matrix, in one launch. Replaces
//                       pollen_tpu/kernels/crossmat.py _kernel (K2),
//                       depth-only variant included.
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
//     word p/32) by a one-ballot-per-warp launch ahead of the kernel
//     (K1, K3, K9), so the caller hands over the raw 0/1 mask and pays
//     one host call.
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
//   * Heavy function (K1's heavy phase): byte row r holds path 2r in
//     its low nibble and path 2r+1 in its high nibble (int8 layout: row
//     = path). A block covers 128 columns; each thread reads 4 columns
//     as one 32-bit word and walks every 8th row, and the 8 row groups
//     are summed in shared memory. The row loop is warp-uniform, so rows
//     whose paths are all unselected are skipped without divergence and
//     their bytes are never read. Sums are exact int32 (no bf16 detour).
//   * K2 (cross_kernel) is its own design, one launch a call:
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

// K2: see the design notes above.
constexpr int X_COLS = 16;                    // columns a thread owns
constexpr int X_WARP_COLS = 32 * X_COLS;      // a warp's columns
constexpr int X_BLOCK_COLS = H_GROUPS * X_WARP_COLS;  // a block's, 1 group
constexpr int X_BATCH = 8;         // list rows in flight a thread
constexpr int X_ROW_CHUNK = 2048;  // list entries staged at a time
constexpr int X_MIN_BLOCKS = 2;    // at most 128 registers a thread

struct CrossArgs {
  const uint8_t* a;  // (rows, n_pad) nibble or int8 cells
  int rows;
  long long n_pad;   // a multiple of 128
  const void* mask;  // raw 0/1 mask, n_paths entries of elem_bytes
  int elem_bytes;
  int n_paths;
  int* depth;        // int32[n_pad]
  int* uniq;         // int32[n_pad] (unused by the depth-only variant)
  int groups;        // row groups a block splits its list into: 1-8
  int tiles;         // column tiles of X_BLOCK_COLS / groups
};

// Row r's code: bit 0 the low nibble's path (or the int8 row's), bit 1
// the high nibble's.
template <bool NIBBLE>
__device__ __forceinline__ int row_code(const CrossArgs& x, long long r) {
  const auto bit = [&](long long p) {
    return raw_mask_bit(x.mask, x.elem_bytes, x.n_paths, p);
  };
  return NIBBLE ? bit(2 * r) | bit(2 * r + 1) << 1 : bit(r);
}

// The rows [r0, r0 + cnt) with a selected path, as row << 2 | code in
// `list` (code bit 0: the low nibble's path, or the int8 row's; bit 1:
// the high nibble's); returns how many. The order is arbitrary: the
// sums are integers. Every thread of the block calls it.
template <bool NIBBLE>
__device__ int stage_rows(const CrossArgs& x, int r0, int cnt, int* list,
                          int* count) {
  __syncthreads();  // the previous list has been read
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < cnt; base += THREADS) {  // block-uniform
    const int i = base + threadIdx.x;
    const int code = i < cnt ? row_code<NIBBLE>(x, r0 + i) : 0;
    const unsigned b = __ballot_sync(0xFFFFFFFFu, code != 0);
    int at = 0;
    if (lane == 0 && b) at = atomicAdd(count, __popc(b));
    at = __shfl_sync(0xFFFFFFFFu, at, 0) + __popc(b & ((1u << lane) - 1u));
    if (code) list[at] = (r0 + i) << 2 | code;
  }
  __syncthreads();
  return *count;
}

template <bool VEC>
__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned* q = reinterpret_cast<const unsigned*>(p);
  return make_uint4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
}

__device__ __forceinline__ unsigned word_of(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// Adds list rows [lo, hi) of the 16 columns at `col` into d and u.
template <bool NIBBLE, bool WANT_U, bool VEC>
__device__ __forceinline__ void cross_rows(const CrossArgs& x, long long col,
                                           const int* list, int lo, int hi,
                                           int (&d)[X_COLS],
                                           int (&u)[X_COLS]) {
  int n_sel = 0;  // rows with a selected path
  for (int b = lo; b < hi; b += X_BATCH) {
    uint4 v[X_BATCH];
    int code[X_BATCH];
#pragma unroll
    for (int k = 0; k < X_BATCH; ++k) {
      const int e = b + k < hi ? list[b + k] : 0;  // code 0: no row
      code[k] = e & 3;
      n_sel += code[k] != 0;
      v[k] = code[k] ? load16<VEC>(x.a + (long long)(e >> 2) * x.n_pad + col)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (NIBBLE) {
        unsigned ds = 0, us = 0;  // byte lanes: <= 240 and <= 16
#pragma unroll
        for (int k = 0; k < X_BATCH; ++k) {
          const unsigned q = word_of(v[k], w);
          const unsigned lo_n = q & (code[k] & 1 ? 0x0F0F0F0Fu : 0u);
          const unsigned hi_n = (q >> 4) & (code[k] & 2 ? 0x0F0F0F0Fu : 0u);
          ds += lo_n + hi_n;
          if (WANT_U) {
            us += (((lo_n + 0x0F0F0F0Fu) & 0x10101010u) +
                   ((hi_n + 0x0F0F0F0Fu) & 0x10101010u)) >> 4;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          d[4 * w + j] += (int)__byte_perm(ds, 0u, 0x4440u + j);
          if (WANT_U) u[4 * w + j] += (int)__byte_perm(us, 0u, 0x4440u + j);
        }
      } else {
        // 16-bit lanes of a + 128: even bytes, odd bytes (<= 2040).
        unsigned de = 0, dod = 0, ue = 0, uod = 0;
#pragma unroll
        for (int k = 0; k < X_BATCH; ++k) {
          const unsigned q =
              (word_of(v[k], w) ^ 0x80808080u) & (code[k] ? ~0u : 0u);
          de += q & 0x00FF00FFu;
          dod += (q >> 8) & 0x00FF00FFu;
          if (WANT_U) {
            const unsigned m = __vminu4(q, 0x81818181u);
            ue += m & 0x00FF00FFu;
            uod += (m >> 8) & 0x00FF00FFu;
          }
        }
        d[4 * w] += (int)(de & 0xFFFFu);
        d[4 * w + 1] += (int)(dod & 0xFFFFu);
        d[4 * w + 2] += (int)(de >> 16);
        d[4 * w + 3] += (int)(dod >> 16);
        if (WANT_U) {
          u[4 * w] += (int)(ue & 0xFFFFu);
          u[4 * w + 1] += (int)(uod & 0xFFFFu);
          u[4 * w + 2] += (int)(ue >> 16);
          u[4 * w + 3] += (int)(uod >> 16);
        }
      }
    }
  }
  if (!NIBBLE) {
    const int off = 128 * n_sel;
#pragma unroll
    for (int j = 0; j < X_COLS; ++j) {
      d[j] -= off;
      if (WANT_U) u[j] -= off;
    }
  }
}

__device__ __forceinline__ void store16(int* p, const int (&v)[X_COLS]) {
#pragma unroll
  for (int j = 0; j < X_COLS; j += 4) {
    *reinterpret_cast<int4*>(p + j) =
        make_int4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  }
}

template <bool NIBBLE, bool WANT_U, bool VEC>
__global__ void __launch_bounds__(THREADS, X_MIN_BLOCKS)
    cross_kernel(CrossArgs x) {
  __shared__ int s_list[X_ROW_CHUNK];
  __shared__ int s_count;
  __shared__ __align__(16) int s_red[2][X_BLOCK_COLS];  // groups > 1
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpg = H_GROUPS / x.groups;  // warps a row group
  const int g = warp / wpg;
  const int cols = X_WARP_COLS * wpg;  // a tile's columns
  const int local = (warp % wpg) * X_WARP_COLS + lane * X_COLS;
  const int chunks = (x.rows + X_ROW_CHUNK - 1) / X_ROW_CHUNK;
  int n_sel = chunks == 1
                  ? stage_rows<NIBBLE>(x, 0, x.rows, s_list, &s_count)
                  : 0;
  for (int tile = blockIdx.x; tile < x.tiles; tile += gridDim.x) {
    const long long col = (long long)tile * cols + local;
    const bool live = col < x.n_pad;  // all 16 columns or none
    int d[X_COLS], u[X_COLS];
#pragma unroll
    for (int j = 0; j < X_COLS; ++j) d[j] = u[j] = 0;
    for (int c = 0; c < chunks; ++c) {  // block-uniform
      if (chunks > 1) {
        n_sel = stage_rows<NIBBLE>(x, c * X_ROW_CHUNK,
                                   min(X_ROW_CHUNK, x.rows - c * X_ROW_CHUNK),
                                   s_list, &s_count);
      }
      const int lo = (int)((long long)n_sel * g / x.groups);
      const int hi = (int)((long long)n_sel * (g + 1) / x.groups);
      if (live) cross_rows<NIBBLE, WANT_U, VEC>(x, col, s_list, lo, hi, d, u);
    }
    if (x.groups == 1) {
      if (live) {
        store16(x.depth + col, d);
        if (WANT_U) store16(x.uniq + col, u);
      }
      continue;
    }
    if (live) {
      store16(&s_red[0][g * cols + local], d);
      if (WANT_U) store16(&s_red[1][g * cols + local], u);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < cols; c += THREADS) {
      const long long oc = (long long)tile * cols + c;
      if (oc >= x.n_pad) break;
      int sd = 0, su = 0;
      for (int gi = 0; gi < x.groups; ++gi) {
        sd += s_red[0][gi * cols + c];
        if (WANT_U) su += s_red[1][gi * cols + c];
      }
      x.depth[oc] = sd;
      if (WANT_U) x.uniq[oc] = su;
    }
    __syncthreads();  // s_red is rewritten by the next tile
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
  }
  return sms;
}

// One launch of K2: at most the blocks the card holds at once (found on
// the first call of each build, before any graph capture).
template <bool NIBBLE, bool WANT_U, bool VEC>
void launch_cross(const CrossArgs& x, cudaStream_t st) {
  static int resident = 0;
  if (resident == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cross_kernel<NIBBLE, WANT_U, VEC>, THREADS, 0);
    resident = sm_count() * (per_sm > 0 ? per_sm : 1);
  }
  const int blocks = x.tiles < resident ? x.tiles : resident;
  cross_kernel<NIBBLE, WANT_U, VEC><<<blocks, THREADS, 0, st>>>(x);
}

template <bool NIBBLE>
void launch_cross_u(const CrossArgs& x, bool want_u, bool vec,
                    cudaStream_t st) {
  if (want_u) {
    vec ? launch_cross<NIBBLE, true, true>(x, st)
        : launch_cross<NIBBLE, true, false>(x, st);
  } else {
    vec ? launch_cross<NIBBLE, false, true>(x, st)
        : launch_cross<NIBBLE, false, false>(x, st);
  }
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
  // Row groups: the fewest that still give every SM two tiles.
  int groups = 1;
  while (groups < H_GROUPS &&
         (n_pad + X_BLOCK_COLS / groups - 1) / (X_BLOCK_COLS / groups) <
             2LL * sm_count()) {
    groups *= 2;
  }
  const int cols = X_BLOCK_COLS / groups;
  CrossArgs x{static_cast<const uint8_t*>(a), rows, n_pad, mask, elem_bytes,
              n_paths, static_cast<int*>(depth), static_cast<int*>(uniq),
              groups, (int)((n_pad + cols - 1) / cols)};
  const bool vec = reinterpret_cast<uintptr_t>(a) % 16 == 0;
  if (nibble) {
    launch_cross_u<true>(x, uniq != nullptr, vec, st);
  } else {
    launch_cross_u<false>(x, uniq != nullptr, vec, st);
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
