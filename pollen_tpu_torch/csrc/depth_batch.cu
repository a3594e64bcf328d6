// Batched masked segment depth: Q subset queries answered in one pass
// over the resident ELL / crossing-matrix indexes (the serving shape:
// one resident graph, a stream of subset queries), written for Hopper
// (sm_90a). Two entry points share the heavy-column function:
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
//                             packed crossing matrix, depth and uniq.
//                             Replaces pollen_tpu/kernels/crossmat.py
//                             _batched_kernel (K5).
//
// What bounds them on the H100: integer work, a few operations per slot
// or nibble and query; the index (2-8 MB at bench to chromosome scale)
// is read once per launch and the outputs are Q x columns int32, so at
// Q = 32 the output writes (Q x 4 B x 2 per column) outweigh the index
// reads. Both are memory- and latency-bound, far below the compute
// roofline. The TPU kernels ran the heavy phase as a bf16 MXU matmul
// with f32 sums (exact only below 2^24); here every sum is exact int32.
//
//   * Masks: the raw (Q, P) 0/1 masks are packed into bit words in one
//     launch (pack_mask, one grid row per query). Queries run in chunks
//     of 32 (blockIdx.y), so any Q is one launch. A block stages its
//     chunk's words in shared memory when they fit (16 KB: 32 queries
//     of 4096 paths); beyond that it reads them from global memory
//     through L1. The answer is the same either way.
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
//   * Heavy blocks: 128 columns for all queries of the chunk. The 8
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

__global__ void __launch_bounds__(THREADS) cross_batch_kernel(
    const uint8_t* a, int rows, int n_pad, int nibble, const int* words,
    int n_words, int q, int* depth, int* uniq) {
  __shared__ int s_words[MAX_BATCH_SMEM_WORDS];
  __shared__ HeavyScratch s_heavy;
  const long long q0 = (long long)blockIdx.y * QCHUNK;
  const int qc = min(QCHUNK, q - (int)q0);
  const int* w = stage_words(s_words, words + q0 * n_words, qc * n_words,
                             MAX_BATCH_SMEM_WORDS);
  heavy_columns_batch(a, rows, n_pad, nibble, w, n_words, qc, blockIdx.x,
                      depth + q0 * n_pad, uniq + q0 * n_pad, s_heavy);
}

}  // namespace

extern "C" {

// Both entry points take the raw (q, n_paths) masks (`elem_bytes` 1 or
// 4 per path) and a scratch buffer of q*n_words int32 for their bit
// words; outputs are (q, columns) int32.

int pollen_cross_depth_batch(const void* a, int rows, int n_pad, int nibble,
                             const void* masks, int elem_bytes, int n_paths,
                             int q, void* words, int n_words, void* depth,
                             void* uniq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(words);
  pack_mask(masks, elem_bytes, n_paths, q, w, n_words, st);
  const long long blocks = n_pad / H_COLS;
  const unsigned chunks = (unsigned)((q + QCHUNK - 1) / QCHUNK);
  if (blocks > 0) {
    cross_batch_kernel<<<dim3((unsigned)blocks, chunks), THREADS, 0, st>>>(
        static_cast<const uint8_t*>(a), rows, n_pad, nibble, w, n_words, q,
        static_cast<int*>(depth), static_cast<int*>(uniq));
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
