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
// index reads (2-16 MB at bench to chromosome scale) four to one. K5 is
// bound by those stores once its products run on the tensor cores; K4
// still runs its products on the CUDA cores (a few integer operations
// per slot or nibble and query). The TPU kernels ran the heavy phase as
// a bf16 MXU matmul with f32 sums (exact only below 2^24); here every
// sum is exact int32.
//
//   * Masks: the raw (Q, P) 0/1 masks are packed into bit words in one
//     launch (pack_mask, one grid row per query). Queries run in chunks
//     of 32 (blockIdx.y), so any Q is one launch. A K4 block stages its
//     chunk's words in shared memory when they fit (16 KB: 32 queries
//     of 4096 paths); beyond that it reads them from global memory
//     through L1. The answer is the same either way.
//   * K5 (cross_mma_kernel): two int8 tensor-core products per tile,
//     depth = M.A and uniq = M.min(A, 1), with mma.sync m16n8k32
//     s8.s8 -> s32 (no .satfinite: masks are 0/1 and a cell is at most
//     15 or 127, so every sum is below 127 * P < 2^31 and exact). A
//     block takes 128 columns and the chunk's 32 queries; warp w takes
//     32 columns (w % 4) and 16 queries (w / 4). The byte tile is
//     staged 32 rows at a time with cp.async (rows past the matrix
//     filled with zeros), double-buffered, so the next rows load while
//     these multiply. B fragments come from shared memory: four 4-byte
//     row words, transposed with __byte_perm, give one register per
//     column holding 4 rows; nibbles split four cells at a time
//     (w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F) and the indicator is one
//     per-byte min with 1 (__vminu4 / __vmins4, equal to the plain
//     version's clamp). In the nibble layout one K step of 32 is 16
//     byte rows: low nibbles (even paths) first, then high nibbles
//     (odd paths), the folded order of fold_mask within each step. A
//     fragments (the masks) come from the bit words, 4 bits to 4 bytes
//     a register; queries past Q are zero and never stored. The int32
//     results go through shared memory, and each (query, 128 columns)
//     row leaves as 32 coalesced 16-byte stores.
//   * Tier blocks: one thread per output column reads its K slot words
//     once into registers (a template bucket of 1, 2, 4 or 8 words),
//     then loops over the chunk's queries: per query one shared-memory
//     bit lookup per slot and one store each to depth[q, col] and
//     uniq[q, col], coalesced across the warp. Columns come out in
//     natural order (no unfold pass). Tiers of more than 8 stored words
//     run in chunks of 8 that add into the outputs. The cap keeps the
//     kernel at 80 registers a thread: the compiler keeps every decoded
//     slot of the bucket live across the query loop, and a 32-word
//     bucket took 168-255.
//   * K4 heavy blocks: 128 columns for all queries of the chunk. The 8
//     warps split into QG query groups x RG row groups: from 8 queries
//     up QG = 8 and each warp holds at most 4 queries x 4 columns x 2
//     int32 accumulators (32 registers at Q = 32); below 8 queries the
//     idle warps take row groups instead, summed in shared memory (at
//     Q = 1 this is the single-query K2 scheme). A row is skipped,
//     warp-uniformly, when none of the warp's queries selects either of
//     its paths (the OR of their bits), so its bytes are not read. The
//     warps of a block read the same tile through L1.

#include "common.cuh"

namespace {

constexpr int QCHUNK = 32;  // queries per block (blockIdx.y chunk)
constexpr int QPW = 4;      // queries per warp, at most (QCHUNK / 8)
constexpr int MAX_BATCH_SMEM_WORDS = 4096;  // 16 KB of staged mask words
constexpr int KC_MAX = 8;   // slot words held in registers

// Per-warp partial sums of a heavy block whose warps split rows (fewer
// than 8 queries, so at most 2 queries per warp).
struct HeavyScratch {
  int d[H_GROUPS][2][H_COLS];
  int u[H_GROUPS][2][H_COLS];
};

// kc (<= KC) slot words of one column, read once, then every query of
// the chunk. depth/uniq point at this column of query 0; query rows are
// `cols` apart. `add` accumulates onto an earlier chunk of words.
template <int KC, bool P16>
__device__ __forceinline__ void tier_words_batch(
    const int* __restrict__ slots, long long at, long long stride, int kc,
    const int* words, int n_words, int qc, int* depth, int* uniq,
    long long cols, bool add) {
  unsigned v[KC];
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    v[kk] = kk < kc ? (unsigned)__ldg(slots + at + kk * stride) : 0u;
  }
  for (int qq = 0; qq < qc; ++qq) {
    const int* w = words + qq * n_words;
    int d = 0;
    int u = 0;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      if (P16) {
        // Two path<<8|count halves; the low half is the even slot.
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const unsigned h = (v[kk] >> (16 * half)) & 0xFFFFu;
          const int bit = mask_bit(w, n_words, (h >> 8) & 0xFFu);
          d += bit * (int)(h & 0xFFu);
          u += bit & (int)(h != 0u);
        }
      } else {
        // path<<16|count; unsigned shifts, so paths >= 2^15 stay positive.
        const int bit = mask_bit(w, n_words, (v[kk] >> 16) & 0xFFFFu);
        d += bit * (int)(v[kk] & 0xFFFFu);
        u += bit & (int)(v[kk] != 0u);
      }
    }
    const long long o = qq * cols;
    if (add) {
      depth[o] += d;
      uniq[o] += u;
    } else {
      depth[o] = d;
      uniq[o] = u;
    }
  }
}

template <bool P16>
__device__ __forceinline__ void tier_words_dispatch(
    const int* slots, long long at, long long stride, int kc,
    const int* words, int n_words, int qc, int* depth, int* uniq,
    long long cols, bool add) {
  if (kc <= 1) {
    tier_words_batch<1, P16>(slots, at, stride, kc, words, n_words, qc,
                             depth, uniq, cols, add);
  } else if (kc <= 2) {
    tier_words_batch<2, P16>(slots, at, stride, kc, words, n_words, qc,
                             depth, uniq, cols, add);
  } else if (kc <= 4) {
    tier_words_batch<4, P16>(slots, at, stride, kc, words, n_words, qc,
                             depth, uniq, cols, add);
  } else {
    tier_words_batch<KC_MAX, P16>(slots, at, stride, kc, words, n_words,
                                  qc, depth, uniq, cols, add);
  }
}

// One tier, block `blk` of its g*sub*COL_BLOCKS blocks, for queries
// [q0, q0 + qc); t.depth / t.uniq are (Q, g*sub*TALL_W).
__device__ __forceinline__ void tier_column_batch(
    const Tier& t, int sub, int pack16, const int* words, int n_words,
    int qc, long long q0, long long blk) {
  const long long tile_row = blk / COL_BLOCKS;  // g*sub + r
  const int c = (int)(blk % COL_BLOCKS) * THREADS + threadIdx.x;
  const long long g = tile_row / sub;
  const int r = (int)(tile_row % sub);
  const long long cols = (long long)t.g * sub * TALL_W;
  const long long n = tile_row * TALL_W + c;
  int* depth = t.depth + q0 * cols + n;
  int* uniq = t.uniq + q0 * cols + n;
  const long long stride = (long long)sub * TALL_W;  // next slot word
  for (int kb = 0; kb < t.k; kb += KC_MAX) {
    const int kc = min(KC_MAX, t.k - kb);
    const long long at = ((g * t.k + kb) * sub + r) * TALL_W + c;
    if (pack16) {
      tier_words_dispatch<true>(t.slots, at, stride, kc, words, n_words, qc,
                                depth, uniq, cols, kb > 0);
    } else {
      tier_words_dispatch<false>(t.slots, at, stride, kc, words, n_words,
                                 qc, depth, uniq, cols, kb > 0);
    }
  }
}

// One query's mask bits for byte row r: nibble layout, bit 0 = path 2r
// (low nibble) and bit 1 = path 2r+1 (high nibble), one word since 2r
// is even; int8 layout, bit 0 = path r.
__device__ __forceinline__ unsigned row_bits(
    const int* w, int n_words, int r, int nibble) {
  const unsigned p = nibble ? 2u * r : (unsigned)r;
  const unsigned wi = p >> 5;
  if (wi >= (unsigned)n_words) return 0u;
  return ((unsigned)w[wi] >> (p & 31u)) & (nibble ? 3u : 1u);
}

// Heavy / dense block: 128 columns starting at blk*128 for queries
// [0, qc) of the chunk (qc <= QCHUNK). depth/uniq are the chunk's query
// rows, n_pad apart.
__device__ __forceinline__ void heavy_columns_batch(
    const uint8_t* __restrict__ a, int rows, int n_pad, int nibble,
    const int* words, int n_words, int qc, long long blk, int* depth,
    int* uniq, HeavyScratch& s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qg_n = qc >= 8 ? 8 : qc >= 4 ? 4 : qc >= 2 ? 2 : 1;
  const int rg_n = H_GROUPS / qg_n;
  const int qg = warp % qg_n;  // warp = rg * qg_n + qg
  const int rg = warp / qg_n;
  const long long col0 = blk * H_COLS;
  const long long col = col0 + lane * 4;
  int d[QPW][4] = {};
  int u[QPW][4] = {};
  for (int r = rg; r < rows; r += rg_n) {
    unsigned mb[QPW];
    unsigned any = 0u;
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int qq = qg + qg_n * j;
      mb[j] = qq < qc ? row_bits(words + qq * n_words, n_words, r, nibble)
                      : 0u;
      any |= mb[j];
    }
    if (!any) continue;  // warp-uniform: every lane has these bits
    const unsigned v = __ldg(reinterpret_cast<const unsigned*>(
        a + (long long)r * n_pad + col));
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned b = (v >> (8 * c)) & 0xFFu;
      if (nibble) {
        const int lo = (int)(b & 15u);
        const int hi = (int)(b >> 4);
        const int nlo = lo != 0;
        const int nhi = hi != 0;
#pragma unroll
        for (int j = 0; j < QPW; ++j) {
          const int m0 = (int)(mb[j] & 1u);
          const int m1 = (int)(mb[j] >> 1);
          d[j][c] += m0 * lo + m1 * hi;
          u[j][c] += (m0 & nlo) + (m1 & nhi);
        }
      } else {
        const int x = (int)(int8_t)b;
        const int nx = x != 0;
#pragma unroll
        for (int j = 0; j < QPW; ++j) {
          const int m0 = (int)mb[j];
          d[j][c] += m0 * x;
          u[j][c] += m0 & nx;
        }
      }
    }
  }
  if (rg_n == 1) {  // block-uniform (depends on qc only)
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int qq = qg + qg_n * j;
      if (qq < qc) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          depth[(long long)qq * n_pad + col + c] = d[j][c];
          uniq[(long long)qq * n_pad + col + c] = u[j][c];
        }
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s.d[warp][j][lane * 4 + c] = d[j][c];
      s.u[warp][j][lane * 4 + c] = u[j][c];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < qg_n * 2 * H_COLS; i += THREADS) {
    const int g = i / (2 * H_COLS);
    const int j = (i / H_COLS) & 1;
    const int c = i % H_COLS;
    const int qq = g + qg_n * j;
    if (qq >= qc) continue;
    int sd = 0;
    int su = 0;
    for (int k = 0; k < rg_n; ++k) {
      sd += s.d[k * qg_n + g][j][c];
      su += s.u[k * qg_n + g][j][c];
    }
    depth[(long long)qq * n_pad + col0 + c] = sd;
    uniq[(long long)qq * n_pad + col0 + c] = su;
  }
}

__global__ void __launch_bounds__(THREADS) ell_splitn_batch_kernel(
    Tier t0, Tier t1, Tier t2, int nt, const uint8_t* heavy, int h_rows,
    int nh_pad, int* dh, int* uh, int sub, int pack16, const int* words,
    int n_words, int q) {
  __shared__ int s_words[MAX_BATCH_SMEM_WORDS];
  __shared__ HeavyScratch s_heavy;
  const long long q0 = (long long)blockIdx.y * QCHUNK;
  const int qc = min(QCHUNK, q - (int)q0);
  const int* w = stage_words(s_words, words + q0 * n_words, qc * n_words,
                             MAX_BATCH_SMEM_WORDS);
  long long b = blockIdx.x;  // block-uniform: no divergent phase picks
  const Tier* tiers[3] = {&t0, &t1, &t2};
  for (int i = 0; i < nt; ++i) {
    const long long nb = (long long)tiers[i]->g * sub * COL_BLOCKS;
    if (b < nb) {
      tier_column_batch(*tiers[i], sub, pack16, w, n_words, qc, q0, b);
      return;
    }
    b -= nb;
  }
  heavy_columns_batch(heavy, h_rows, nh_pad, 1, w, n_words, qc, b,
                      dh + q0 * nh_pad, uh + q0 * nh_pad, s_heavy);
}

// ---------------------------------------------------------------------
// K5 on the int8 tensor cores (see the notes at the top).
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

struct MmaSmem {
  uint8_t a[2][MMA_ROWS * MMA_PITCH];     // double-buffered byte tiles
  int out[2][QCHUNK * MMA_OUT_PITCH];     // depth, uniq of the block
};

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

// Bit word `wi` of chunk query qq, 0 past Q or past the mask.
__device__ __forceinline__ unsigned query_word(const int* w, int n_words,
                                               int qq, int qc, int wi) {
  return qq < qc && wi < n_words
             ? (unsigned)__ldg(w + (long long)qq * n_words + wi)
             : 0u;
}

// One block: columns [128 * blockIdx.x, +128) for the chunk's queries.
// Fragment lane roles: g = lane / 4 is the query row (A, C) and the
// column (B), t = lane % 4 picks K and column pairs. The K order inside
// a step is free as long as A and B agree; it is chosen so that byte i
// of a B register is row t + 4i (nibble) or t + 8i (int8): consecutive
// rows across t (no bank conflicts) and A registers that are one shift
// and mask of a bit word. Column j of the 4 a thread transposes is
// column n = g of mma j: physical column cw + 4g + j.
template <bool NIBBLE, bool VEC16>
__global__ void __launch_bounds__(THREADS, 4) cross_mma_kernel(
    const uint8_t* __restrict__ a, int rows, int n_pad,
    const int* __restrict__ words, int n_words, int q, int* depth,
    int* uniq) {
  __shared__ __align__(16) MmaSmem s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cw = (warp & 3) * 32;   // the warp's first column
  const int mq = (warp >> 2) * 16;  // its first query of the chunk
  const long long col0 = (long long)blockIdx.x * MMA_COLS;
  const int q0 = blockIdx.y * QCHUNK;
  const int qc = min(QCHUNK, q - q0);
  const int* w = words + (long long)q0 * n_words;
  const bool busy = mq < qc;  // warp-uniform
  int d[4][4] = {};
  int u[4][4] = {};
  const unsigned ones = 0x01010101u;
  const int tiles = (rows + MMA_ROWS - 1) / MMA_ROWS;
  if (tiles > 0) stage_tile<VEC16>(s.a[0], a, rows, n_pad, col0, 0);
  for (int k = 0; k < tiles; ++k) {
    if (k + 1 < tiles) {
      stage_tile<VEC16>(s.a[(k + 1) & 1], a, rows, n_pad, col0,
                        (k + 1) * MMA_ROWS);
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
        const unsigned wa = query_word(w, n_words, mq + g, qc, r0 / 16);
        const unsigned wb = query_word(w, n_words, mq + g + 8, qc, r0 / 16);
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
      const unsigned wa = query_word(w, n_words, mq + g, qc, k);
      const unsigned wb = query_word(w, n_words, mq + g + 8, qc, k);
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
    __syncthreads();  // this buffer is refilled two tiles on
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
    int* dst = (o ? uniq : depth) + (long long)(q0 + qq) * n_pad + col0;
    *reinterpret_cast<int4*>(dst + 4 * lane) = v;
  }
}

}  // namespace

extern "C" {

// Both entry points take the raw (q, n_paths) masks (`elem_bytes` 1 or
// 4 per path) and a scratch buffer of q*n_words int32 for their bit
// words; outputs are (q, columns) int32 (16-byte aligned rows for K5:
// n_pad is a multiple of 128).

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

int pollen_ell_splitn_batch(
    int nt, const void* s0, int k0, int g0, void* d0, void* u0,
    const void* s1, int k1, int g1, void* d1, void* u1, const void* s2,
    int k2, int g2, void* d2, void* u2, const void* heavy, int h_rows,
    int nh_pad, void* dh, void* uh, int sub, int pack16, const void* masks,
    int elem_bytes, int n_paths, int q, void* words, int n_words,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(words);
  pack_mask(masks, elem_bytes, n_paths, q, w, n_words, st);
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
  const unsigned chunks = (unsigned)((q + QCHUNK - 1) / QCHUNK);
  if (blocks > 0) {
    ell_splitn_batch_kernel<<<dim3((unsigned)blocks, chunks), THREADS, 0,
                              st>>>(
        t[0], t[1], t[2], nt, static_cast<const uint8_t*>(heavy), h_rows,
        nh_pad, static_cast<int*>(dh), static_cast<int*>(uh), sub, pack16, w,
        n_words, q);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
