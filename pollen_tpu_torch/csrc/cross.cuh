// The dense query's tile over a crossing matrix (K2's design, depth.cu
// notes): the selected-row list built from the raw mask in shared
// memory, 16-byte row loads 8 rows in flight, SIMD byte lanes, row groups
// at small matrices, on a persistent grid. K2 (pollen_cross_depth) and
// K1's heavy tiles (pollen_ell_splitn) run it in depth.cu, the probe
// ladder (pollen_cross_probe) in probes.cu; each source gets its own copy
// (anonymous namespace, as common.cuh).
//
// Two template parameters say what a tile sums and stores:
//   CELLS  CELLS_NIBBLE: two nibble counts a byte (path 2r low, 2r + 1
//          high); CELLS_INT8: one int8 count a byte; CELLS_RAW: the raw
//          byte under the even path's bit, no unpack (the probes' floor).
//   U      U_SUM: uniq = the nonzero indicators' sum; U_NONE: no uniq
//          (K2's depth-only variant); U_COPY: uniq = depth; U_FLAG: per
//          warp, U_SUM where the warp's flag (x.flags[col / FLAG_COLS])
//          is nonzero, else U_COPY. A warp's 512 columns are one flag's
//          at every row-group count, so the branch is warp-uniform.

#pragma once

#include "common.cuh"

namespace {

constexpr int X_COLS = 16;                    // columns a thread owns
constexpr int X_WARP_COLS = 32 * X_COLS;      // a warp's columns
constexpr int X_BLOCK_COLS = H_GROUPS * X_WARP_COLS;  // a block's, 1 group
constexpr int X_BATCH = 8;         // list rows in flight a thread
constexpr int X_ROW_CHUNK = 2048;  // list entries staged at a time
constexpr int X_MIN_BLOCKS = 2;    // at most 128 registers a thread
constexpr int FLAG_COLS = X_WARP_COLS;  // columns of one U_FLAG flag

constexpr int CELLS_INT8 = 0;
constexpr int CELLS_NIBBLE = 1;
constexpr int CELLS_RAW = 2;
constexpr int U_NONE = 0;
constexpr int U_SUM = 1;
constexpr int U_COPY = 2;
constexpr int U_FLAG = 3;

struct CrossArgs {
  const uint8_t* a;  // (rows, n_pad) nibble or int8 cells
  int rows;
  long long n_pad;   // a multiple of 128
  const void* mask;  // raw 0/1 mask, n_paths entries of elem_bytes
  int elem_bytes;
  int n_paths;
  int* depth;        // int32[n_pad]
  int* uniq;         // int32[n_pad] (unused under U_NONE)
  int groups;        // row groups a block splits its list into: 1-8
  int tiles;         // column tiles of X_BLOCK_COLS / groups
  const int* flags;  // U_FLAG: int32[ceil(n_pad / FLAG_COLS)]
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
template <int CELLS, bool WANT_U, bool VEC>
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
      if (CELLS == CELLS_NIBBLE) {
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
        // 16-bit lanes (even bytes, odd bytes) of a + 128 for int8 rows,
        // of the raw byte under the even path's bit (code bit 0) for
        // CELLS_RAW: <= 2040 over 8 rows either way.
        constexpr unsigned FLIP = CELLS == CELLS_INT8 ? 0x80808080u : 0u;
        unsigned de = 0, dod = 0, ue = 0, uod = 0;
#pragma unroll
        for (int k = 0; k < X_BATCH; ++k) {
          const unsigned q =
              (word_of(v[k], w) ^ FLIP) & (code[k] & 1 ? ~0u : 0u);
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
  if (CELLS == CELLS_INT8) {
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

// One column tile: the list rows of each row group summed into its
// columns (list chunks restaged here when the rows pass X_ROW_CHUNK),
// the groups added in shared memory, the sums stored. `n_sel` is the
// staged list's length. Every thread of the block calls it.
template <int CELLS, int U, bool VEC>
__device__ __forceinline__ void cross_tile(const CrossArgs& x, int tile,
                                           int& n_sel, int* s_list,
                                           int* s_count,
                                           int (*s_red)[X_BLOCK_COLS]) {
  constexpr bool NIBBLE_LIST = CELLS != CELLS_INT8;
  constexpr bool SUMS_U = U == U_SUM || U == U_FLAG;  // s_red[1] in use
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpg = H_GROUPS / x.groups;  // warps a row group
  const int g = warp / wpg;
  const int cols = X_WARP_COLS * wpg;  // a tile's columns
  const int local = (warp % wpg) * X_WARP_COLS + lane * X_COLS;
  const int chunks = (x.rows + X_ROW_CHUNK - 1) / X_ROW_CHUNK;
  const long long col = (long long)tile * cols + local;
  const bool live = col < x.n_pad;  // all 16 columns or none
  // The same for every live lane of a warp (its columns share a flag).
  const bool want_u =
      U == U_SUM || (U == U_FLAG && live && __ldg(x.flags + col / FLAG_COLS));
  int d[X_COLS], u[X_COLS];
#pragma unroll
  for (int j = 0; j < X_COLS; ++j) d[j] = u[j] = 0;
  for (int c = 0; c < chunks; ++c) {  // block-uniform
    if (chunks > 1) {
      n_sel = stage_rows<NIBBLE_LIST>(
          x, c * X_ROW_CHUNK, min(X_ROW_CHUNK, x.rows - c * X_ROW_CHUNK),
          s_list, s_count);
    }
    const int lo = (int)((long long)n_sel * g / x.groups);
    const int hi = (int)((long long)n_sel * (g + 1) / x.groups);
    if (!live) continue;
    if (U == U_FLAG && !want_u) {
      cross_rows<CELLS, false, VEC>(x, col, s_list, lo, hi, d, u);
    } else {
      cross_rows<CELLS, SUMS_U, VEC>(x, col, s_list, lo, hi, d, u);
    }
  }
  if (U == U_FLAG && !want_u) {
#pragma unroll
    for (int j = 0; j < X_COLS; ++j) u[j] = d[j];
  }
  if (x.groups == 1) {
    if (live) {
      store16(x.depth + col, d);
      if (U == U_COPY) store16(x.uniq + col, d);
      if (SUMS_U) store16(x.uniq + col, u);
    }
    return;
  }
  if (live) {
    store16(&s_red[0][g * cols + local], d);
    if (SUMS_U) store16(&s_red[1][g * cols + local], u);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += THREADS) {
    const long long oc = (long long)tile * cols + c;
    if (oc >= x.n_pad) break;
    int sd = 0, su = 0;
    for (int gi = 0; gi < x.groups; ++gi) {
      sd += s_red[0][gi * cols + c];
      if (SUMS_U) su += s_red[1][gi * cols + c];
    }
    x.depth[oc] = sd;
    if (U == U_COPY) x.uniq[oc] = sd;
    if (SUMS_U) x.uniq[oc] = su;
  }
  __syncthreads();  // s_red is rewritten by the next tile
}

template <int CELLS, int U, bool VEC>
__global__ void __launch_bounds__(THREADS, X_MIN_BLOCKS)
    cross_kernel(CrossArgs x) {
  __shared__ int s_list[X_ROW_CHUNK];
  __shared__ int s_count;
  __shared__ __align__(16) int s_red[2][X_BLOCK_COLS];  // groups > 1
  const int chunks = (x.rows + X_ROW_CHUNK - 1) / X_ROW_CHUNK;
  int n_sel = chunks == 1 ? stage_rows<CELLS != CELLS_INT8>(
                                x, 0, x.rows, s_list, &s_count)
                          : 0;
  for (int tile = blockIdx.x; tile < x.tiles; tile += gridDim.x) {
    cross_tile<CELLS, U, VEC>(x, tile, n_sel, s_list, &s_count, s_red);
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

// Row groups of the tiles over n_pad columns: the fewest that still give
// every SM two tiles.
int cross_groups(long long n_pad) {
  int groups = 1;
  while (groups < H_GROUPS &&
         (n_pad + X_BLOCK_COLS / groups - 1) / (X_BLOCK_COLS / groups) <
             2LL * sm_count()) {
    groups *= 2;
  }
  return groups;
}

// x's row groups and tiles for its n_pad columns.
void plan_cross(CrossArgs& x) {
  x.groups = cross_groups(x.n_pad);
  const int cols = X_BLOCK_COLS / x.groups;
  x.tiles = (int)((x.n_pad + cols - 1) / cols);
}

// One launch: at most the blocks the card holds at once (found on the
// first call of each build, before any graph capture).
template <int CELLS, int U, bool VEC>
void launch_cross(const CrossArgs& x, cudaStream_t st) {
  static int resident = 0;
  if (resident == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cross_kernel<CELLS, U, VEC>, THREADS, 0);
    resident = sm_count() * (per_sm > 0 ? per_sm : 1);
  }
  const int blocks = x.tiles < resident ? x.tiles : resident;
  cross_kernel<CELLS, U, VEC><<<blocks, THREADS, 0, st>>>(x);
}

}  // namespace
