// Batched masked segment depth: Q subset queries answered in one pass
// over the resident ELL / crossing-matrix indexes (the serving shape:
// one resident graph, a stream of subset queries), written for Hopper
// (sm_90a). Two entry points:
//
//   pollen_ell_splitn_batch   up to three tier phases plus the heavy
//                             phase for Q masks in ONE launch. Replaces
//                             pollen_tpu/kernels/ellscan.py
//                             _kernel_splitn_batch (K4). The reference's
//                             per-tier split emission (masked_ell_splitn_
//                             depth_batch_split) existed only for Mosaic's
//                             16 MB scoped-VMEM ceiling and has no
//                             counterpart: one launch serves 1-3 tiers.
//   pollen_cross_depth_batch  Q masked GEMVs over a nibble- or int8-
//                             packed crossing matrix, depth and uniq,
//                             on the int8 tensor cores. Replaces
//                             pollen_tpu/kernels/crossmat.py
//                             _batched_kernel (K5).
//
// What bounds them on the H100: the outputs are Q x columns int32, so
// at Q = 32 the output writes (Q x 4 B x 2 per column) outweigh the
// index reads (2-16 MB at bench to chromosome scale) four to one. Both
// are bound by those stores once the products are off the critical
// path: K5 and K4's heavy phase run them on the tensor cores, K4's tier
// phase spends one mask lookup a slot for all 32 queries of a chunk.
// The TPU kernels ran the heavy phase as a bf16 MXU matmul with f32
// sums (exact only below 2^24); here every sum is exact int32.
//
//   * Masks: K5 packs the raw (Q, P) 0/1 masks into bit words in one
//     launch (pack_mask, one grid row per query). K4 reads them raw:
//     up to 4096 paths each block builds the bits it needs from the raw
//     masks (chunk_bits: one coalesced load a lane for each of the
//     chunk's queries, 16 KB at most); past that one launch packs them
//     into a global buffer, read through L1. Queries run in chunks of
//     32 (blockIdx.y), so any Q is one launch.
//   * The tensor-core tile (mma_tile; K5's blocks and K4's heavy
//     blocks): two int8 products per tile, depth = M.A and
//     uniq = M.min(A, 1), with mma.sync m16n8k32 s8.s8 -> s32 (no
//     .satfinite: masks are 0/1 and a cell is at most 15 or 127, so
//     every sum is below 127 * P < 2^31 and exact). A block takes 128
//     columns and the chunk's 32 queries; warp w takes 32 columns
//     (w % 4) and 16 queries (w / 4). The byte tile is staged 32 rows
//     at a time with cp.async (rows past the matrix filled with zeros),
//     double-buffered, so the next rows load while these multiply. B
//     fragments come from shared memory: four 4-byte row words,
//     transposed with __byte_perm, give one register per column holding
//     4 rows; nibbles split four cells at a time (w & 0x0F0F0F0F,
//     (w >> 4) & 0x0F0F0F0F) and the indicator is one per-byte min with
//     1 (__vminu4 / __vmins4, equal to the plain version's clamp). In
//     the nibble layout one K step of 32 is 16 byte rows: low nibbles
//     (even paths) first, then high nibbles (odd paths), the folded
//     order of fold_mask within each step. A fragments (the masks) come
//     from query-major bit words, 4 bits to 4 bytes a register; queries
//     past Q are zero and never stored. The int32 results go through
//     shared memory, and each (query, 128 columns) row leaves as 32
//     coalesced 16-byte stores.
//   * K4's grid: the heavy blocks (one tensor-core tile each, the
//     longest blocks) first, then the tier blocks. Both phases' shared
//     memory is one dynamic allocation, sized per call: the tile's
//     buffers (44 KB) plus its query-major bits, or the tier block's
//     path-major bits, whichever the block is.
//   * K4's tier blocks: a thread owns 4 adjacent columns, so a slot word
//     of the tall layout (tall[(g*K + kk)*SUB + r, c], contiguous in c)
//     is one 16-byte load, issued before the block builds its mask bits.
//     The bits are path-major: the word of path p holds bit j for query
//     j of the chunk, so one shared-memory lookup a slot serves all 32
//     queries; a slot keeps that word (0 for an empty slot) and its
//     count in registers. Then per query: one bit extract and
//     multiply-add a slot, and each (query, output) row leaves as one
//     16-byte store a thread. Up to 8 slots a column are held at a time
//     (4 pack16 words, 8 32-bit words: 64 registers for 4 columns);
//     longer tiers run in chunks that add into the outputs. Columns
//     come out in natural order (no unfold pass).

#include "common.cuh"

namespace {

constexpr int QCHUNK = 32;  // queries per block (blockIdx.y chunk)
constexpr int BLOCK_BITS_WORDS = 128;  // mask words a block builds (4096 paths)
constexpr int T_COLS = 4;   // tier columns a thread owns
constexpr int T_BLOCK_COLS = THREADS * T_COLS;
constexpr int T_ROW_TILES = TALL_W / T_BLOCK_COLS;  // tier blocks a tall row
constexpr int T_SLOTS = 8;  // slots a column held in registers
constexpr int K4_MIN_BLOCKS = 2;  // at most 128 registers a thread

// ---------------------------------------------------------------------
// The tensor-core tile (see the notes at the top).
// ---------------------------------------------------------------------

constexpr int MMA_COLS = 128;  // columns per block: 4 warps x 32
constexpr int MMA_ROWS = 32;   // byte rows per staged tile
// Row pitches in shared memory, padded so that a warp's fragment reads
// (4 consecutive rows x 8 words) and its 16-byte result writes (2 rows x
// 4 pieces per quarter warp) fall on distinct banks.
constexpr int MMA_PITCH = MMA_COLS + 32;     // bytes
constexpr int MMA_OUT_PITCH = MMA_COLS + 4;  // int32 words
static_assert(THREADS == MMA_ROWS * (MMA_COLS / 16),
              "one 16-byte copy per thread stages a tile");
static_assert(MMA_COLS == H_COLS, "a heavy block is one tensor-core tile");

struct MmaSmem {
  uint8_t a[2][MMA_ROWS * MMA_PITCH];     // double-buffered byte tiles
  int out[2][QCHUNK * MMA_OUT_PITCH];     // depth, uniq of the block
};
static_assert(sizeof(MmaSmem) % 16 == 0, "the bits after it stay aligned");

// BYTES (16 or 4) bytes from global to shared memory, asynchronously;
// zeros where src_bytes is 0.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  }
}

// Byte rows [r0, r0 + 32) of the block's 128 columns into `dst`; rows at
// or past `rows` read as zero. 16-byte copies where the matrix is
// 16-byte aligned (VEC16), else 4-byte ones.
template <bool VEC16>
__device__ __forceinline__ void stage_tile(uint8_t* dst, const uint8_t* a,
                                           int rows, int n_pad,
                                           long long col0, int r0) {
  const int r = threadIdx.x >> 3;
  const int c = (threadIdx.x & 7) * 16;
  const bool in = r0 + r < rows;
  const uint8_t* src = in ? a + (long long)(r0 + r) * n_pad + col0 + c : a;
  uint8_t* d = dst + r * MMA_PITCH + c;
  if (VEC16) {
    cp_async<16>(d, src, in ? 16 : 0);
  } else {
#pragma unroll
    for (int k = 0; k < 16; k += 4) {
      cp_async<4>(d + k, in ? src + k : src, in ? 4 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Four row words (byte j = column j) -> four column words (byte i = row
// i).
__device__ __forceinline__ void transpose4(const unsigned (&w)[4],
                                           unsigned (&c)[4]) {
  const unsigned t0 = __byte_perm(w[0], w[1], 0x5140);
  const unsigned t1 = __byte_perm(w[0], w[1], 0x7362);
  const unsigned t2 = __byte_perm(w[2], w[3], 0x5140);
  const unsigned t3 = __byte_perm(w[2], w[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// D += A.B, m16n8k32, s8 x s8 -> s32, wrapping (no .satfinite).
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A thread's accumulators of 4 mmas into shared memory at `row` (query
// g, column 8t): c0, c1 of mma j are query g, columns 8t + j and
// 8t + 4 + j; c2, c3 the same columns of query g + 8.
__device__ __forceinline__ void stage_results(const int (&c)[4][4],
                                              int* row) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int* r = row + 8 * h * MMA_OUT_PITCH;
    *reinterpret_cast<int4*>(r) =
        make_int4(c[0][2 * h], c[1][2 * h], c[2][2 * h], c[3][2 * h]);
    *reinterpret_cast<int4*>(r + 4) = make_int4(
        c[0][2 * h + 1], c[1][2 * h + 1], c[2][2 * h + 1], c[3][2 * h + 1]);
  }
}

// Query-major bit words of a query chunk: word `wi` of chunk query qq,
// 0 past the chunk or past the mask. K5 reads packed words from global
// memory through the read-only path; K4 reads the words its block built
// (or the packing launch's) through a plain load.
struct LdgWords {
  const int* w;
  int n_words;
  int qc;
  __device__ __forceinline__ unsigned operator()(int qq, int wi) const {
    return qq < qc && wi < n_words
               ? (unsigned)__ldg(w + (long long)qq * n_words + wi)
               : 0u;
  }
};

struct PlainWords {
  const int* w;
  int n_words;
  int qc;
  __device__ __forceinline__ unsigned operator()(int qq, int wi) const {
    return qq < qc && wi < n_words ? (unsigned)w[qq * n_words + wi] : 0u;
  }
};

// One tensor-core tile: columns [col0, col0 + 128) of `a` for the qc
// (<= 32) queries of a chunk, whose rows of `depth` and `uniq` start at
// the pointers given, n_pad apart. `stage()` runs once every thread has
// issued the first two tiles' copies (K4 builds the mask bits there, so
// they overlap); `words` is read only after it. Fragment lane roles:
// g = lane / 4 is the query row (A, C) and the column (B), t = lane % 4
// picks K and column pairs. The K order inside a step is free as long
// as A and B agree; it is chosen so that byte i of a B register is row
// t + 4i (nibble) or t + 8i (int8): consecutive rows across t (no bank
// conflicts) and A registers that are one shift and mask of a bit word.
// Column j of the 4 a thread transposes is column n = g of mma j:
// physical column cw + 4g + j.
template <bool NIBBLE, bool VEC16, class Words, class Stage>
__device__ __forceinline__ void mma_tile(const uint8_t* __restrict__ a,
                                         int rows, int n_pad, long long col0,
                                         const Words& words, int qc,
                                         int* depth, int* uniq, MmaSmem& s,
                                         const Stage& stage) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cw = (warp & 3) * 32;   // the warp's first column
  const int mq = (warp >> 2) * 16;  // its first query of the chunk
  const bool busy = mq < qc;  // warp-uniform
  int d[4][4] = {};
  int u[4][4] = {};
  const unsigned ones = 0x01010101u;
  const int tiles = (rows + MMA_ROWS - 1) / MMA_ROWS;
  // Both buffers fill before stage(); tile k + 2 refills tile k's.
  for (int k = 0; k < 2 && k < tiles; ++k) {
    stage_tile<VEC16>(s.a[k], a, rows, n_pad, col0, k * MMA_ROWS);
  }
  stage();
  for (int k = 0; k < tiles; ++k) {
    if (k + 1 < tiles) {
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const uint8_t* tile = s.a[k & 1] + cw + 4 * g;
    if (busy && NIBBLE) {
      // Two K steps of 16 byte rows (32 paths, bit word r0 / 16): low
      // nibbles (path 2r) first, then high nibbles (path 2r + 1).
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r0 = k * MMA_ROWS + h * 16;
        if (r0 >= rows) break;  // block-uniform
        const unsigned wa = words(mq + g, r0 / 16);
        const unsigned wb = words(mq + g + 8, r0 / 16);
        const unsigned am[4] = {(wa >> (2 * t)) & ones, (wb >> (2 * t)) & ones,
                                (wa >> (2 * t + 1)) & ones,
                                (wb >> (2 * t + 1)) & ones};
        unsigned rw[4], cl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rw[i] = *reinterpret_cast<const unsigned*>(
              tile + (h * 16 + t + 4 * i) * MMA_PITCH);
        }
        transpose4(rw, cl);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned lo = cl[j] & 0x0F0F0F0Fu;
          const unsigned hi = (cl[j] >> 4) & 0x0F0F0F0Fu;
          mma_s8(d[j], am, lo, hi);
          mma_s8(u[j], am, __vminu4(lo, ones), __vminu4(hi, ones));
        }
      }
    } else if (busy) {
      // One K step of 32 rows (paths, bit word k): rows t + 8i, then
      // t + 4 + 8i.
      const unsigned wa = words(mq + g, k);
      const unsigned wb = words(mq + g + 8, k);
      const unsigned am[4] = {(wa >> t) & ones, (wb >> t) & ones,
                              (wa >> (t + 4)) & ones, (wb >> (t + 4)) & ones};
      unsigned r_lo[4], r_hi[4], c_lo[4], c_hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        r_lo[i] = *reinterpret_cast<const unsigned*>(
            tile + (t + 8 * i) * MMA_PITCH);
        r_hi[i] = *reinterpret_cast<const unsigned*>(
            tile + (t + 4 + 8 * i) * MMA_PITCH);
      }
      transpose4(r_lo, c_lo);
      transpose4(r_hi, c_hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_s8(d[j], am, c_lo[j], c_hi[j]);
        // min(x, 1) per signed byte: the plain version's clamp.
        mma_s8(u[j], am, __vmins4(c_lo[j], ones), __vmins4(c_hi[j], ones));
      }
    }
    __syncthreads();  // this buffer is free: tile k + 2 goes into it
    if (k + 2 < tiles) {
      stage_tile<VEC16>(s.a[k & 1], a, rows, n_pad, col0,
                        (k + 2) * MMA_ROWS);
    }
  }
  // Accumulator c0, c1 of mma j is query g, logical columns 2t, 2t + 1:
  // physical columns 8t + j and 8t + 4 + j. So a thread holds columns
  // 8t .. 8t + 7 of queries g and g + 8, two 16-byte pieces each.
  if (busy) {
    const int at = (mq + g) * MMA_OUT_PITCH + cw + 8 * t;
    stage_results(d, s.out[0] + at);
    stage_results(u, s.out[1] + at);
  }
  __syncthreads();
  // Whole rows out: (output, query) row rr of 2 x qc to warp rr % 8,
  // 512 bytes a row, 16 bytes a lane.
  for (int rr = warp; rr < 2 * qc; rr += THREADS / 32) {
    const int o = rr >= qc;
    const int qq = rr - o * qc;
    const int4 v = *reinterpret_cast<const int4*>(
        s.out[o] + qq * MMA_OUT_PITCH + 4 * lane);
    int* dst = (o ? uniq : depth) + (long long)qq * n_pad + col0;
    *reinterpret_cast<int4*>(dst + 4 * lane) = v;
  }
}

// K5: one block, columns [128 * blockIdx.x, +128) for the chunk's
// queries.
template <bool NIBBLE, bool VEC16>
__global__ void __launch_bounds__(THREADS, 4) cross_mma_kernel(
    const uint8_t* __restrict__ a, int rows, int n_pad,
    const int* __restrict__ words, int n_words, int q, int* depth,
    int* uniq) {
  __shared__ __align__(16) MmaSmem s;
  const int q0 = blockIdx.y * QCHUNK;
  const int qc = min(QCHUNK, q - q0);
  const long long at = (long long)q0 * n_pad;
  mma_tile<NIBBLE, VEC16>(
      a, rows, n_pad, (long long)blockIdx.x * MMA_COLS,
      LdgWords{words + (long long)q0 * n_words, n_words, qc}, qc, depth + at,
      uniq + at, s, [] {});
}

// ---------------------------------------------------------------------
// K4 (see the notes at the top).
// ---------------------------------------------------------------------

// The bits of the chunk's queries [0, qc) (rows of `masks`, n_paths
// apart) for the 32 paths of word `wi`, one path a lane: into `pm` the
// path-major word of path 32 wi + lane (bit j: query j), into `qw` each
// query's word wi (qw[j * n_words + wi]); either may be null. Every lane
// of the warp calls it.
__device__ __forceinline__ void chunk_bits(const void* masks, int elem_bytes,
                                           int n_paths, int qc, int wi,
                                           int n_words, int* pm, int* qw) {
  const int lane = threadIdx.x & 31;
  const long long p = 32LL * wi + lane;
  const auto* row = static_cast<const uint8_t*>(masks);
  const long long pitch = (long long)n_paths * elem_bytes;
  unsigned path_word = 0u;
#pragma unroll
  for (int j = 0; j < QCHUNK; ++j) {  // all 32 loads in flight at once
    const int bit =
        j < qc ? raw_mask_bit(row + j * pitch, elem_bytes, n_paths, p) : 0;
    path_word |= (unsigned)bit << j;
  }
  if (pm != nullptr) pm[p] = (int)path_word;
  if (qw == nullptr) return;
  // Ballots only after every load: a ballot between two loads would
  // hold the second back until the first returned.
  unsigned mine = 0u;
#pragma unroll
  for (int j = 0; j < QCHUNK; ++j) {
    const unsigned b = __ballot_sync(0xFFFFFFFFu, (path_word >> j) & 1u);
    if (lane == j) mine = b;
  }
  if (lane < qc) qw[lane * n_words + wi] = (int)mine;
}

// Past BLOCK_BITS_WORDS words: the chunks' path-major bits (n_words * 32
// a chunk) and query-major words (n_words a query), one warp a word.
__global__ void __launch_bounds__(THREADS) batch_bits_kernel(
    const void* masks, int elem_bytes, int n_paths, int q, int n_words,
    int* pm, int* qw) {
  const int wi = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const long long q0 = (long long)blockIdx.y * QCHUNK;
  if (wi >= n_words) return;  // warp-uniform
  chunk_bits(static_cast<const uint8_t*>(masks) + q0 * n_paths * elem_bytes,
             elem_bytes, n_paths, min(QCHUNK, q - (int)q0), wi, n_words,
             pm + (long long)blockIdx.y * n_words * 32, qw + q0 * n_words);
}

struct BatchArgs {
  Tier t[3];
  int nt;
  int sub;
  int pack16;
  const uint8_t* heavy;  // (h_rows, nh_pad) nibbles, or null
  int h_rows;
  int nh_pad;
  int* dh;               // (q, nh_pad)
  int* uh;
  int heavy_blocks;      // nh_pad / 128, 0 without a heavy block
  const void* masks;     // raw (q, n_paths), elem_bytes an entry
  int elem_bytes;
  int n_paths;
  int q;
  int n_words;           // ceil(n_paths / 32)
  const int* g_pm;       // packed bits past BLOCK_BITS_WORDS, else null
  const int* g_qw;
};

// W slot words of 4 columns (zero past the tier's), then every query of
// the chunk. `v` holds the words (loaded before the mask bits were
// built); depth/uniq point at these columns of query 0, query rows
// `cols` apart; `add` accumulates onto an earlier chunk of words.
template <int W, bool P16>
__device__ __forceinline__ void tier_emit(const uint4 (&v)[W],
                                          const int* pm, int n_paths,
                                          int qc, int* depth, int* uniq,
                                          long long cols, bool add) {
  constexpr int S = P16 ? 2 * W : W;  // slots a column
  unsigned bits[T_COLS][S];
  int cnt[T_COLS][S];
#pragma unroll
  for (int kk = 0; kk < W; ++kk) {
    const unsigned word[T_COLS] = {v[kk].x, v[kk].y, v[kk].z, v[kk].w};
#pragma unroll
    for (int c = 0; c < T_COLS; ++c) {
#pragma unroll
      for (int half = 0; half < (P16 ? 2 : 1); ++half) {
        unsigned path, n, nz;
        if (P16) {
          // Two path<<8|count halves; the low half is the even slot.
          const unsigned h = (word[c] >> (16 * half)) & 0xFFFFu;
          path = h >> 8;
          n = h & 0xFFu;
          nz = h;
        } else {
          // path<<16|count; unsigned shifts, so paths >= 2^15 stay positive.
          path = word[c] >> 16;
          n = word[c] & 0xFFFFu;
          nz = word[c];
        }
        const int s = P16 ? 2 * kk + half : kk;
        const bool live = nz != 0u && path < (unsigned)n_paths;
        bits[c][s] = live ? (unsigned)pm[path] : 0u;
        cnt[c][s] = (int)n;
      }
    }
  }
  for (int j = 0; j < qc; ++j) {
    int d[T_COLS], u[T_COLS];
#pragma unroll
    for (int c = 0; c < T_COLS; ++c) {
      d[c] = u[c] = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int b = (int)((bits[c][s] >> j) & 1u);
        d[c] += b * cnt[c][s];
        u[c] += b;
      }
    }
    int4* pd = reinterpret_cast<int4*>(depth + j * cols);
    int4* pu = reinterpret_cast<int4*>(uniq + j * cols);
    if (add) {
      const int4 od = *pd, ou = *pu;
      d[0] += od.x; d[1] += od.y; d[2] += od.z; d[3] += od.w;
      u[0] += ou.x; u[1] += ou.y; u[2] += ou.z; u[3] += ou.w;
    }
    *pd = make_int4(d[0], d[1], d[2], d[3]);
    *pu = make_int4(u[0], u[1], u[2], u[3]);
  }
}

// One tier block: 4 columns a thread of tall row `tile_row` (g*sub + r)
// for the chunk's queries, in chunks of W words. `stage()` builds the
// path-major bits (once, after the first words are in flight) and
// returns them.
template <int W, bool P16, class Stage>
__device__ __forceinline__ void tier_block(const Tier& t, int sub,
                                           long long tile_row, int c,
                                           const Stage& stage, int n_paths,
                                           int qc, long long q0) {
  const long long g = tile_row / sub;
  const int r = (int)(tile_row % sub);
  const long long cols = (long long)t.g * sub * TALL_W;
  const long long n = q0 * cols + tile_row * TALL_W + c;
  const long long stride = (long long)sub * TALL_W;  // next slot word
  const int* pm = nullptr;
  for (int kb = 0; kb < t.k; kb += W) {  // block-uniform
    const int kc = min(W, t.k - kb);
    const int* at = t.slots + ((g * t.k + kb) * sub + r) * TALL_W + c;
    uint4 v[W];
#pragma unroll
    for (int kk = 0; kk < W; ++kk) {
      v[kk] = kk < kc ? __ldg(reinterpret_cast<const uint4*>(at + kk * stride))
                      : make_uint4(0u, 0u, 0u, 0u);
    }
    if (kb == 0) pm = stage();
    tier_emit<W, P16>(v, pm, n_paths, qc, t.depth + n, t.uniq + n, cols,
                      kb > 0);
  }
}

template <bool VEC16>
__global__ void __launch_bounds__(THREADS, K4_MIN_BLOCKS)
    ell_splitn_batch_kernel(BatchArgs x) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long q0 = (long long)blockIdx.y * QCHUNK;
  const int qc = min(QCHUNK, x.q - (int)q0);
  const void* masks =
      static_cast<const uint8_t*>(x.masks) + q0 * x.n_paths * x.elem_bytes;
  const int warp = threadIdx.x >> 5;
  long long b = blockIdx.x;  // block-uniform: no divergent phase picks
  if (b < x.heavy_blocks) {
    auto& s = *reinterpret_cast<MmaSmem*>(smem);
    int* qw = reinterpret_cast<int*>(smem + sizeof(MmaSmem));
    const bool built = x.g_qw == nullptr;
    const auto stage = [&] {
      if (!built) return;
      for (int wi = warp; wi < x.n_words; wi += THREADS / 32) {
        chunk_bits(masks, x.elem_bytes, x.n_paths, qc, wi, x.n_words,
                   nullptr, qw);
      }
      __syncthreads();
    };
    const PlainWords words{built ? qw : x.g_qw + q0 * x.n_words, x.n_words,
                           qc};
    mma_tile<true, VEC16>(x.heavy, x.h_rows, x.nh_pad, b * MMA_COLS, words,
                          qc, x.dh + q0 * x.nh_pad, x.uh + q0 * x.nh_pad, s,
                          stage);
    return;
  }
  b -= x.heavy_blocks;
  int* s_pm = reinterpret_cast<int*>(smem);
  const auto stage = [&]() -> const int* {
    if (x.g_pm != nullptr) {
      return x.g_pm + (long long)blockIdx.y * x.n_words * 32;
    }
    for (int wi = warp; wi < x.n_words; wi += THREADS / 32) {
      chunk_bits(masks, x.elem_bytes, x.n_paths, qc, wi, x.n_words, s_pm,
                 nullptr);
    }
    __syncthreads();
    return s_pm;
  };
  for (int i = 0; i < x.nt; ++i) {
    const Tier& t = x.t[i];
    const long long nb = (long long)t.g * x.sub * T_ROW_TILES;
    if (b >= nb) {
      b -= nb;
      continue;
    }
    const long long tile_row = b / T_ROW_TILES;
    const int c = (int)(b % T_ROW_TILES) * T_BLOCK_COLS + threadIdx.x * T_COLS;
    // The smallest bucket that holds the tier's words, at most T_SLOTS
    // slots a column (pack16: two a word).
    const int slots = x.pack16 ? 2 * t.k : t.k;
    if (x.pack16) {
      if (slots <= 2) {
        tier_block<1, true>(t, x.sub, tile_row, c, stage, x.n_paths, qc, q0);
      } else if (slots <= 4) {
        tier_block<2, true>(t, x.sub, tile_row, c, stage, x.n_paths, qc, q0);
      } else {
        tier_block<T_SLOTS / 2, true>(t, x.sub, tile_row, c, stage, x.n_paths,
                                      qc, q0);
      }
    } else if (slots <= 1) {
      tier_block<1, false>(t, x.sub, tile_row, c, stage, x.n_paths, qc, q0);
    } else if (slots <= 2) {
      tier_block<2, false>(t, x.sub, tile_row, c, stage, x.n_paths, qc, q0);
    } else if (slots <= 4) {
      tier_block<4, false>(t, x.sub, tile_row, c, stage, x.n_paths, qc, q0);
    } else {
      tier_block<T_SLOTS, false>(t, x.sub, tile_row, c, stage, x.n_paths, qc,
                                 q0);
    }
    return;
  }
}

// Dynamic shared memory of a K4 block: the tile's buffers when a heavy
// block is present, plus the block's own mask bits when they fit.
constexpr int K4_SMEM_MAX = (int)sizeof(MmaSmem) + BLOCK_BITS_WORDS * 32 * 4;

// Int32 scratch words K4 needs for q masks of n_paths (ellscan.py
// batch_scratch_words): none while a block builds its own bits, else the
// packed path-major bits of every query chunk and the query-major words
// of every query.
long long batch_scratch_words(int q, int n_paths) {
  const long long n_words = n_paths > 32 ? (n_paths + 31) / 32 : 1;
  if (n_words <= BLOCK_BITS_WORDS) return 0;
  const long long chunks = (q + QCHUNK - 1) / QCHUNK;
  return chunks * n_words * 32 + (long long)q * n_words;
}

template <bool VEC16>
void launch_splitn_batch(const BatchArgs& x, dim3 grid, int smem,
                         cudaStream_t st) {
  static bool raised = false;
  if (!raised) {
    cudaFuncSetAttribute(ell_splitn_batch_kernel<VEC16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         K4_SMEM_MAX);
    raised = true;
  }
  ell_splitn_batch_kernel<VEC16><<<grid, THREADS, smem, st>>>(x);
}

}  // namespace

extern "C" {

// K5 takes the raw (q, n_paths) masks (`elem_bytes` 1 or 4 per path)
// and a scratch buffer of q*n_words int32 for their bit words; outputs
// are (q, columns) int32 (16-byte aligned rows: n_pad is a multiple of
// 128).
int pollen_cross_depth_batch(const void* a, int rows, int n_pad, int nibble,
                             const void* masks, int elem_bytes, int n_paths,
                             int q, void* words, int n_words, void* depth,
                             void* uniq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(words);
  pack_mask(masks, elem_bytes, n_paths, q, w, n_words, st);
  const dim3 grid((unsigned)(n_pad / MMA_COLS),
                  (unsigned)((q + QCHUNK - 1) / QCHUNK));
  if (grid.x > 0) {
    const auto* m = static_cast<const uint8_t*>(a);
    int* d = static_cast<int*>(depth);
    int* u = static_cast<int*>(uniq);
    const bool vec16 = (reinterpret_cast<uintptr_t>(a) & 15u) == 0;
    auto kernel = nibble ? (vec16 ? cross_mma_kernel<true, true>
                                  : cross_mma_kernel<true, false>)
                         : (vec16 ? cross_mma_kernel<false, true>
                                  : cross_mma_kernel<false, false>);
    kernel<<<grid, THREADS, 0, st>>>(m, rows, n_pad, w, n_words, q, d, u);
  }
  return (int)cudaGetLastError();
}

// K4 takes the raw (q, n_paths) masks and the scratch of
// batch_scratch_words (`scratch_words` long). Tier slots and all outputs
// are 16-byte aligned; outputs are (q, columns) int32.
int pollen_ell_splitn_batch(
    int nt, const void* s0, int k0, int g0, void* d0, void* u0,
    const void* s1, int k1, int g1, void* d1, void* u1, const void* s2,
    int k2, int g2, void* d2, void* u2, const void* heavy, int h_rows,
    int nh_pad, void* dh, void* uh, int sub, int pack16, const void* masks,
    int elem_bytes, int n_paths, int q, void* scratch,
    long long scratch_words, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_words = n_paths > 32 ? (n_paths + 31) / 32 : 1;
  BatchArgs x{
      {{static_cast<const int*>(s0), k0, g0, static_cast<int*>(d0),
        static_cast<int*>(u0)},
       {static_cast<const int*>(s1), k1, g1, static_cast<int*>(d1),
        static_cast<int*>(u1)},
       {static_cast<const int*>(s2), k2, g2, static_cast<int*>(d2),
        static_cast<int*>(u2)}},
      nt, sub, pack16, static_cast<const uint8_t*>(heavy), h_rows, nh_pad,
      static_cast<int*>(dh), static_cast<int*>(uh), 0, masks, elem_bytes,
      n_paths, q, n_words, nullptr, nullptr};
  uintptr_t align = 0;
  for (int i = 0; i < nt; ++i) {
    align |= reinterpret_cast<uintptr_t>(x.t[i].slots) |
             reinterpret_cast<uintptr_t>(x.t[i].depth) |
             reinterpret_cast<uintptr_t>(x.t[i].uniq);
  }
  if (heavy != nullptr) {
    align |= reinterpret_cast<uintptr_t>(dh) | reinterpret_cast<uintptr_t>(uh);
    if (nh_pad % MMA_COLS || reinterpret_cast<uintptr_t>(heavy) % 4) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const long long need = batch_scratch_words(q, n_paths);
  if (align % 16 || scratch_words < need || q < 1) {
    return (int)cudaErrorInvalidValue;
  }
  long long blocks = 0;
  for (int i = 0; i < nt; ++i) {
    blocks += (long long)x.t[i].g * sub * T_ROW_TILES;
  }
  if (heavy != nullptr) x.heavy_blocks = nh_pad / MMA_COLS;
  blocks += x.heavy_blocks;
  if (blocks == 0) return (int)cudaGetLastError();
  const unsigned chunks = (unsigned)((q + QCHUNK - 1) / QCHUNK);
  int smem = x.heavy_blocks > 0 ? (int)sizeof(MmaSmem) : 0;
  if (need > 0) {
    int* pm = static_cast<int*>(scratch);
    int* qw = pm + (long long)chunks * n_words * 32;
    const dim3 grid((unsigned)((n_words + THREADS / 32 - 1) / (THREADS / 32)),
                    chunks);
    batch_bits_kernel<<<grid, THREADS, 0, st>>>(masks, elem_bytes, n_paths, q,
                                                n_words, pm, qw);
    x.g_pm = pm;
    x.g_qw = qw;
  } else {
    smem += n_words * 32 * 4;  // either kind of bits: 32 queries x n_words
  }
  const dim3 grid((unsigned)blocks, chunks);
  if (heavy == nullptr || reinterpret_cast<uintptr_t>(heavy) % 16 == 0) {
    launch_splitn_batch<true>(x, grid, smem, st);
  } else {
    launch_splitn_batch<false>(x, grid, smem, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
