// The crossing-matrix probe ladder, written for Hopper (sm_90a): four
// variants of the dense query (K2, depth.cu pollen_cross_depth), each one
// stage from the next, so that their times on the card split the shipped
// K2 into its load floor, its nibble unpack and its uniq indicator. One
// entry point, pollen_cross_probe. Replaces the TPU probes
//
//   raw, vd  probes/crossmat_floor.py _make with _kernel_raw and
//            _kernel_vd (K10)
//   v1       probes/crossmat_variants.py cross_depth_v1 (K11)
//   v2       probes/crossmat_variants.py cross_depth_v2 (K12)
//
// What they compute, over a uint8 (P/2, N) nibble matrix (byte row r:
// path 2r in the low nibble, path 2r+1 in the high one) and a raw 0/1
// mask:
//
//   raw  depth = sum_r mask[2r] * byte[r, n] (the raw byte, no unpack),
//        stored to both outputs;
//   vd   the exact masked depth, stored to both outputs;
//   v1   exact depth and uniq: the same function as K2;
//   v2   v1, except that a 512-column tile whose flag is 0 stores depth
//        as uniq (exact where the flags mark every tile holding a nibble
//        >= 2).
//
// Every rung IS K2's kernel (cross_kernel in cross.cuh), one launch on
// its persistent grid, told by two template parameters what to sum and
// store: each block builds the selected-row list from the raw mask in
// shared memory (no packing launch, no scratch), reads 16 bytes a row
// with 8 rows in flight, sums in SIMD byte lanes and splits the list
// into row groups at small matrices, exactly as K2 does. So the rungs
// differ from K2, and from one another, only in the stage they probe:
//
//   v1   K2's nibble tile with the uniq indicator (CELLS_NIBBLE, U_SUM);
//   vd   K2's depth-only tile, its depth stored twice (U_COPY);
//   raw  the same loads with no unpack: the byte under the even path's
//        bit, summed in 16-bit lanes as K2's int8 rows are (a byte lane
//        would overflow on the second row) (CELLS_RAW, U_COPY);
//   v2   per warp, v1's sums or vd's by the warp's flag (U_FLAG). A flag
//        covers one warp's 512 columns (32 lanes x 16) at every row-group
//        count, so the branch is warp-uniform; a matrix whose columns
//        are not a multiple of 512 has a narrower last tile.
//
// What bounds them on the H100: one pass over the byte rows the mask
// selects at about one multiply-add per nibble, so bytes (3.35 TB/s), as
// for K2. Sums are exact int32 (the TPU's bf16 dots with f32
// accumulation are exact only below 2^24).

#include "cross.cuh"

namespace {

constexpr int MODE_RAW = 0;
constexpr int MODE_VD = 1;
constexpr int MODE_V1 = 2;
constexpr int MODE_V2 = 3;

template <int CELLS, int U>
void launch_probe(const CrossArgs& x, bool vec, cudaStream_t st) {
  vec ? launch_cross<CELLS, U, true>(x, st)
      : launch_cross<CELLS, U, false>(x, st);
}

}  // namespace

extern "C" {

// mode 0 raw, 1 vd, 2 v1, 3 v2 (`flags`: one int32 per 512 columns,
// ceil(n_pad / 512), read by v2 only). Takes the raw mask (`elem_bytes`
// 1 or 4 per path). `a` is 4-byte aligned (16-byte aligned for the
// 16-byte loads) with a multiple of 128 columns; `depth` and `uniq`
// 16-byte aligned.
int pollen_cross_probe(int mode, const void* a, int rows, long long n_pad,
                       const void* mask, int elem_bytes, int n_paths,
                       const void* flags, void* depth, void* uniq,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode < MODE_RAW || mode > MODE_V2 ||
      (mode == MODE_V2 && flags == nullptr) || n_pad % H_COLS ||
      reinterpret_cast<uintptr_t>(a) % 4 ||
      (reinterpret_cast<uintptr_t>(depth) |
       reinterpret_cast<uintptr_t>(uniq)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_pad <= 0) return (int)cudaGetLastError();
  CrossArgs x{static_cast<const uint8_t*>(a), rows, n_pad, mask, elem_bytes,
              n_paths, static_cast<int*>(depth), static_cast<int*>(uniq),
              1, 0, static_cast<const int*>(flags)};
  plan_cross(x);
  const bool vec = reinterpret_cast<uintptr_t>(a) % 16 == 0;
  switch (mode) {
    case MODE_RAW:
      launch_probe<CELLS_RAW, U_COPY>(x, vec, st);
      break;
    case MODE_VD:
      launch_probe<CELLS_NIBBLE, U_COPY>(x, vec, st);
      break;
    case MODE_V1:
      launch_probe<CELLS_NIBBLE, U_SUM>(x, vec, st);
      break;
    default:
      launch_probe<CELLS_NIBBLE, U_FLAG>(x, vec, st);
      break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
