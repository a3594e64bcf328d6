// The crossing-matrix probe ladder, written for Hopper (sm_90a): four
// variants of the masked nibble GEMV, each one stage from the next, so
// that their times on the card split the dense query (K2, depth.cu
// pollen_cross_depth) into its floor, the unpack and the uniq indicator.
// One entry point, pollen_cross_probe, and one kernel templated on the
// mode. Replaces the TPU probes
//
//   raw, vd  probes/crossmat_floor.py _make with _kernel_raw and
//            _kernel_vd (K10)
//   v1       probes/crossmat_variants.py cross_depth_v1 (K11)
//   v2       probes/crossmat_variants.py cross_depth_v2 (K12)
//
// What they compute, over a uint8 (P/2, N) nibble matrix (byte row r:
// path 2r in the low nibble, path 2r+1 in the high one) and a 0/1 mask:
//
//   raw  depth = sum_r mask[2r] * byte[r, n] (the raw byte, no unpack),
//        stored to both outputs;
//   vd   the exact masked depth, stored to both outputs;
//   v1   exact depth and uniq: the same function as K2;
//   v2   v1, except that a block whose flag is 0 stores depth as uniq
//        (exact where the flag marks every block holding a nibble >= 2).
//
// What bounds them on the H100: one pass over the matrix at about one
// multiply-add per nibble, so bytes (3.35 TB/s), as for K2. All four are
// built on K2's heavy_columns structure so that the ladder differs only
// in the stage it probes: a block covers 128 columns, each thread reads
// 4 columns as one 32-bit word and walks every 8th byte row, rows whose
// two paths are both unselected are skipped (warp-uniform) in every
// mode, and the 8 row groups are summed in shared memory. v2's flag is
// one per block (128 columns: the GPU's tile, not the TPU's 8192), and
// the branch on it is block-uniform. Every rung is held to K2's
// occupancy, 8 blocks of 256 threads an SM (at most 32 registers a
// thread), so that the rungs differ in their arithmetic and not in how
// many blocks the register file holds. Sums are exact int32 (the TPU's
// bf16 dots with f32 accumulation are exact only below 2^24).

#include "common.cuh"

namespace {

constexpr int MODE_RAW = 0;
constexpr int MODE_VD = 1;
constexpr int MODE_V1 = 2;
constexpr int MODE_V2 = 3;
constexpr int PROBE_BLOCKS_PER_SM = 8;  // K2's occupancy (31 registers)

// The 128 columns of block blockIdx.x. RAW: raw bytes under the even
// path's bit; WANT_U: the uniq indicator (else uniq = depth).
template <bool RAW, bool WANT_U>
__device__ __forceinline__ void probe_columns(
    const uint8_t* __restrict__ a, int rows, int n_pad, const int* words,
    int n_words, int* depth, int* uniq, int (*s_d)[H_COLS],
    int (*s_u)[H_COLS]) {
  const int lane = threadIdx.x & 31;
  const int grp = threadIdx.x >> 5;
  const long long col0 = (long long)blockIdx.x * H_COLS;
  const long long col = col0 + lane * 4;
  int d[4] = {0, 0, 0, 0};
  int u[4] = {0, 0, 0, 0};
  for (int r = grp; r < rows; r += H_GROUPS) {
    const int m0 = mask_bit(words, n_words, 2u * r);
    const int m1 = mask_bit(words, n_words, 2u * r + 1u);
    if (!(m0 | m1)) continue;  // warp-uniform: every lane has this r
    const unsigned q = __ldg(reinterpret_cast<const unsigned*>(
        a + (long long)r * n_pad + col));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned b = (q >> (8 * j)) & 0xFFu;
      if (RAW) {
        d[j] += m0 * (int)b;
      } else {
        const int lo = (int)(b & 15u);
        const int hi = (int)(b >> 4);
        d[j] += m0 * lo + m1 * hi;
        if (WANT_U) u[j] += (m0 & (int)(lo != 0)) + (m1 & (int)(hi != 0));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s_d[grp][lane * 4 + j] = d[j];
    if (WANT_U) s_u[grp][lane * 4 + j] = u[j];
  }
  __syncthreads();
  if (threadIdx.x < H_COLS) {
    int sd = 0;
    int su = 0;
#pragma unroll
    for (int gi = 0; gi < H_GROUPS; ++gi) {
      sd += s_d[gi][threadIdx.x];
      if (WANT_U) su += s_u[gi][threadIdx.x];
    }
    depth[col0 + threadIdx.x] = sd;
    uniq[col0 + threadIdx.x] = WANT_U ? su : sd;
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, PROBE_BLOCKS_PER_SM) probe_kernel(
    const uint8_t* a, int rows, int n_pad, const int* words, int n_words,
    const int* flags, int* depth, int* uniq) {
  __shared__ int s_words[MAX_SMEM_WORDS];
  __shared__ int s_d[H_GROUPS][H_COLS];
  __shared__ int s_u[H_GROUPS][H_COLS];
  const int* w = stage_words(s_words, words, n_words, MAX_SMEM_WORDS);
  if (MODE == MODE_RAW) {
    probe_columns<true, false>(a, rows, n_pad, w, n_words, depth, uniq, s_d,
                               s_u);
  } else if (MODE == MODE_VD ||
             (MODE == MODE_V2 && __ldg(flags + blockIdx.x) == 0)) {
    probe_columns<false, false>(a, rows, n_pad, w, n_words, depth, uniq, s_d,
                                s_u);
  } else {
    probe_columns<false, true>(a, rows, n_pad, w, n_words, depth, uniq, s_d,
                               s_u);
  }
}

}  // namespace

extern "C" {

// mode 0 raw, 1 vd, 2 v1, 3 v2 (`flags`: one int32 per 128 columns,
// read by v2 only). Takes the raw mask (`elem_bytes` 1 or 4 per path)
// and a scratch buffer of n_words int32 for its bit words.
int pollen_cross_probe(int mode, const void* a, int rows, int n_pad,
                       const void* mask, int elem_bytes, int n_paths,
                       void* words, int n_words, const void* flags,
                       void* depth, void* uniq, void* stream) {
  if (mode < MODE_RAW || mode > MODE_V2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(words);
  pack_mask(mask, elem_bytes, n_paths, 1, w, n_words, st);
  const long long blocks = n_pad / H_COLS;
  if (blocks > 0) {
    const uint8_t* m = static_cast<const uint8_t*>(a);
    const int* f = static_cast<const int*>(flags);
    int* d = static_cast<int*>(depth);
    int* u = static_cast<int*>(uniq);
    const unsigned nb = (unsigned)blocks;
    switch (mode) {
      case MODE_RAW:
        probe_kernel<MODE_RAW><<<nb, THREADS, 0, st>>>(m, rows, n_pad, w,
                                                        n_words, f, d, u);
        break;
      case MODE_VD:
        probe_kernel<MODE_VD><<<nb, THREADS, 0, st>>>(m, rows, n_pad, w,
                                                       n_words, f, d, u);
        break;
      case MODE_V1:
        probe_kernel<MODE_V1><<<nb, THREADS, 0, st>>>(m, rows, n_pad, w,
                                                       n_words, f, d, u);
        break;
      default:
        probe_kernel<MODE_V2><<<nb, THREADS, 0, st>>>(m, rows, n_pad, w,
                                                       n_words, f, d, u);
        break;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
