// The scan family of the masked depth query, written for Hopper
// (sm_90a): the routes that serve graphs past the ELL and crossing-
// matrix budgets (>= 2^16 paths, or POLLEN_CROSS_BUDGET_MB). Three entry
// points:
//
//   pollen_seg_scan      over the (segment, path)-sorted steps: inclusive
//                        cumsums of w = mask[path] and of the first
//                        selected step of each (segment, path) group.
//                        Replaces pollen_tpu/kernels/segscan.py _kernel
//                        (K6), head_carry included (a host int, or an
//                        int32 on the device for the sharded query).
//   pollen_run_scan      over the run index: inclusive cumsums of
//                        mask[run_path] * run_count and of mask[run_path].
//                        Replaces pollen_tpu/kernels/runscan.py _kernel
//                        (K8).
//   pollen_boundary_diff per-segment differences of one or two cumsums
//                        at sorted bounds. Replaces pollen_tpu/kernels/
//                        gatherb.py _kernel (K7) and the adjacent
//                        difference after it.
//
// What bounds them on the H100: memory traffic. K6 and K8 read 8 B and
// write 8 B per element, with a few integer operations each; K7 reads
// its bounds and gathers two values per bound. Design:
//
//   * K6 and K8 are common.cuh's single-pass scan over their own Ops:
//     one scan launch, each input read once with 16-byte loads and each
//     output written once (16 B per element, the minimum). Persistent
//     blocks take 2048-element partitions in ticket order; a
//     partition's prefix crosses blocks through a decoupled look-back
//     over the aggregates below, each packed with its flag into one
//     16-byte descriptor (to_desc), so publishing and reading need no
//     fence. The scratch's counter and descriptors are zeroed on the
//     caller's stream ahead of the launch, so a replayed CUDA graph
//     resets too. What is left between them and the bound: past one
//     wave, the look-back's waits on the predecessors in flight
//     (PERF.md); at one wave (a few hundred partitions) about 4x the
//     bound, not yet split between the memset, the launch and the
//     look-back's rounds.
//   * The mask: up to 8,192 paths each block ballots the raw mask into
//     shared memory, so a call is the memset and the scan; past that a
//     pack_mask launch packs it into bit words once and blocks stage
//     them (16 KB at 2^17 paths), or past 2^17 paths read them from
//     global memory. A lookup is one shift.
//     The TPU's select tournament and one-hot MXU lookup have no place
//     here, nor have its triangular-matmul cumsums and log-step shifts:
//     a thread scans its 8 consecutive elements in registers and warp
//     shuffles order the threads.
//   * "First selected step in its group" is carried by the operator, not
//     by the TPU kernel's prefix max: an aggregate holds the selected
//     count, whether a group starts inside, the selected count of the
//     open (last) group and of the leading partial group, and the first
//     flags counted as if no selected step came before. Composing two
//     aggregates corrects the right one's leading group by the left
//     one's open group, so a group that spans tiles or blocks counts
//     once. A position starts a group where run_start[i] == i, as in the
//     reference; head_carry selected steps open the array's leading
//     group, so negative run_start entries (groups begun on a shard to
//     the left) never match.
//   * K7 is one thread per segment. The bounds are sorted, so a warp's
//     gathers fall on nearby addresses; exact int32 at every size (the
//     TPU's f32 one-hot windows needed < 2^24 steps and an overflow
//     fix-up; neither applies). A bound outside [0, len] is clamped so a
//     corrupt index cannot read outside the cumsum.

#include "common.cuh"

namespace {

// K6: see the design notes above. Counts are int32, as in the reference.
struct SegAgg {
  int sw;  // selected steps
  int hs;  // 1 if a group starts inside
  int t;   // selected steps of the open (last) group; sw if hs == 0
  int l;   // selected steps before the first group start; sw if hs == 0
  int lf;  // first flags, the leading group counted as if opened here
};

struct SegScanOp {
  using Agg = SegAgg;
  const int* x;  // step_path_sorted
  const int* y;  // run_start
  int* out0;     // csum_w
  int* out1;     // csum_first
  long long n;
  const int* words;
  int n_words;
  int head_carry;
  // The carry as an int32 scalar on the device (a sharded query's
  // look-back result); null means head_carry above.
  const int* head_carry_dev;

  static __device__ __forceinline__ Agg identity() { return {0, 0, 0, 0, 0}; }
  static __device__ __forceinline__ Agg combine(const Agg& a, const Agg& b) {
    Agg c;
    c.sw = a.sw + b.sw;
    c.hs = a.hs | b.hs;
    c.t = b.hs ? b.t : a.t + b.sw;
    c.l = a.hs ? a.l : a.l + b.l;
    c.lf = a.lf + b.lf - (int)(a.t > 0 && b.l > 0);
    return c;
  }
  __device__ __forceinline__ Agg element(long long i, int path, int rs,
                                         const int* w) const {
    const int sel = mask_bit(w, n_words, (unsigned)path);
    const int start = (long long)rs == i;
    return {sel, start, sel, start ? 0 : sel, sel};
  }
  // The prefix over [0, i] applied to the state (selected 0, open group
  // head_carry, first flags 0).
  __device__ __forceinline__ void emit(const Agg& p, int* o0, int* o1) const {
    const int carry =
        head_carry_dev != nullptr ? __ldg(head_carry_dev) : head_carry;
    *o0 = p.sw;
    *o1 = p.lf - (int)(carry > 0 && p.l > 0);
  }
  // Look-back descriptor: every count lies in [0, n] with n < 2^31, so
  // each takes 31 bits and the top bits hold hs and the 2-bit flag.
  static __device__ __forceinline__ int4 to_desc(const Agg& a, int flag) {
    return make_int4((int)((unsigned)a.sw | (unsigned)a.hs << 31),
                     (int)((unsigned)a.t | ((unsigned)flag & 1u) << 31),
                     (int)((unsigned)a.l | ((unsigned)flag >> 1) << 31), a.lf);
  }
  static __device__ __forceinline__ int from_desc(const int4& d, Agg& a) {
    a = {d.x & 0x7FFFFFFF, (int)((unsigned)d.x >> 31), d.y & 0x7FFFFFFF,
         d.z & 0x7FFFFFFF, d.w};
    return (int)((unsigned)d.y >> 31 | ((unsigned)d.z >> 31) << 1);
  }
};

// K8: two plain sums. wc wraps as the reference's int32 cumsum does; w
// counts selected runs, at most n < 2^31, so its top bit is free.
struct RunAgg {
  int wc;  // selected run counts
  int w;   // selected runs
};

struct RunScanOp {
  using Agg = RunAgg;
  const int* x;  // run_path
  const int* y;  // run_count
  int* out0;     // csum of mask[run_path] * run_count
  int* out1;     // csum of mask[run_path]
  long long n;
  const int* words;
  int n_words;

  static __device__ __forceinline__ Agg identity() { return {0, 0}; }
  static __device__ __forceinline__ Agg combine(const Agg& a, const Agg& b) {
    return {a.wc + b.wc, a.w + b.w};
  }
  __device__ __forceinline__ Agg element(long long, int path, int count,
                                         const int* w) const {
    const int sel = mask_bit(w, n_words, (unsigned)path);
    return {sel * count, sel};
  }
  __device__ __forceinline__ void emit(const Agg& p, int* o0, int* o1) const {
    *o0 = p.wc;
    *o1 = p.w;
  }
  // Look-back descriptor, tear-evident at 8-byte granularity: it assumes
  // only that each aligned 8-byte half of the 16-byte access is seen
  // whole (the H100 serves the v4 access in one piece; the PTX model
  // promises less). Half 0 is (wc, w | P << 31), P = 1 for FLAG_PREFIX;
  // half 1 is (flag, w). A read is ready only if half 1's flag is AGG or
  // PREFIX, half 0's P bit says the same, and both halves hold the same
  // w. So a read mixing the AGG and PREFIX stores never decodes (the P
  // bits differ), nor one mixing the reset's zeros with a PREFIX store;
  // one mixing the zeros with an AGG store decodes only if that AGG's w
  // is 0, and then its wc is 0 too (no run selected), equal to the
  // zeros.
  static __device__ __forceinline__ int4 to_desc(const Agg& a, int flag) {
    const unsigned p = flag == FLAG_PREFIX;
    return make_int4(a.wc, (int)((unsigned)a.w | p << 31), flag, a.w);
  }
  static __device__ __forceinline__ int from_desc(const int4& d, Agg& a) {
    const unsigned p = (unsigned)d.y >> 31;
    const int w = d.y & 0x7FFFFFFF;
    a = {d.x, w};
    const bool agree = desc_ready(d.z) && p == (unsigned)(d.z == FLAG_PREFIX)
                       && w == d.w;
    return agree ? d.z : 0;
  }
};

__device__ __forceinline__ int exclusive_at(const int* c, long long len,
                                            int b) {
  const long long at = min(max((long long)b, 0LL), len);
  return at == 0 ? 0 : __ldg(c + at - 1);
}

__global__ void __launch_bounds__(THREADS) boundary_diff_kernel(
    const int* c0, const int* c1, long long len, const int* bounds, int n,
    int* o0, int* o1) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int lo = __ldg(bounds + i);
  const int hi = __ldg(bounds + i + 1);
  o0[i] = exclusive_at(c0, len, hi) - exclusive_at(c0, len, lo);
  if (c1 != nullptr) {
    o1[i] = exclusive_at(c1, len, hi) - exclusive_at(c1, len, lo);
  }
}

}  // namespace

extern "C" {

// Bytes of scratch a scan of n elements needs (pollen_seg_scan and
// pollen_run_scan alike): the ticket counter and one descriptor a
// partition.
long long pollen_scan_scratch_bytes(long long n) {
  return single_scan_scratch_bytes(n);
}

// head_carry_dev: null, or an int32 on the device that replaces
// head_carry (read by the kernel, so the caller need not sync).
int pollen_seg_scan(const void* path, const void* run_start, long long n,
                    int head_carry, const void* head_carry_dev,
                    const void* mask, int elem_bytes, int n_paths,
                    void* words, int n_words, void* scratch, void* csum_w,
                    void* csum_first, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* w = static_cast<const int*>(words);
  SegScanOp op{static_cast<const int*>(path),
               static_cast<const int*>(run_start),
               static_cast<int*>(csum_w),
               static_cast<int*>(csum_first),
               n,
               w,
               n_words,
               head_carry,
               static_cast<const int*>(head_carry_dev)};
  const cudaError_t err =
      launch_scan_single(op, mask, elem_bytes, n_paths, scratch, st);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

int pollen_run_scan(const void* run_path, const void* run_count, long long n,
                    const void* mask, int elem_bytes, int n_paths,
                    void* words, int n_words, void* scratch, void* csum_wc,
                    void* csum_w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* w = static_cast<const int*>(words);
  RunScanOp op{static_cast<const int*>(run_path),
               static_cast<const int*>(run_count),
               static_cast<int*>(csum_wc),
               static_cast<int*>(csum_w),
               n,
               w,
               n_words};
  const cudaError_t err =
      launch_scan_single(op, mask, elem_bytes, n_paths, scratch, st);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// `c1`/`o1` may be null (one cumsum). bounds holds n + 1 entries.
int pollen_boundary_diff(const void* c0, const void* c1, long long len,
                         const void* bounds, int n, void* o0, void* o1,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    boundary_diff_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        static_cast<const int*>(c0), static_cast<const int*>(c1), len,
        static_cast<const int*>(bounds), n, static_cast<int*>(o0),
        static_cast<int*>(o1));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
