// Pieces shared by the kernel sources of csrc/: layout constants, the
// mask-bit lookup and the launch that packs 0/1 path masks into bit
// words. Everything is in an anonymous namespace, so each source that
// includes this header gets its own copy (no device linking needed).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TALL_W = 4096;   // tall-layout width (ellscan.py TALL_W)
constexpr int THREADS = 256;   // threads per block, every kernel
constexpr int H_COLS = 128;    // crossing-matrix columns: a multiple of it
constexpr int H_GROUPS = THREADS / 32;  // warps per block
constexpr int MAX_SMEM_WORDS = 2048;    // 2^16 paths of mask bits

struct Tier {
  const int* slots;  // int32[g*k*sub, TALL_W] tall slots
  int k;             // stored words per column
  int g;             // tall row groups
  int* depth;        // int32[(q,) g*sub*TALL_W]
  int* uniq;         // int32[(q,) g*sub*TALL_W]
};

// Stage `count` mask words in shared memory when they fit in `cap`;
// beyond that they stay in global memory (read through L1). Returns the
// pointer to read from. Every thread of the block must call it.
__device__ __forceinline__ const int* stage_words(
    int* s_words, const int* words, int count, int cap) {
  if (count > cap) return words;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    s_words[i] = words[i];
  }
  __syncthreads();
  return s_words;
}

__device__ __forceinline__ int mask_bit(
    const int* words, int n_words, unsigned pid) {
  unsigned w = pid >> 5;
  if (w >= (unsigned)n_words) return 0;
  return (int)(((unsigned)words[w] >> (pid & 31u)) & 1u);
}

// Entry i of a raw 0/1 mask of n_paths entries, one byte or one int32
// (`elem_bytes`) each; 0 past its end.
__device__ __forceinline__ int raw_mask_bit(const void* mask, int elem_bytes,
                                            long long n_paths, long long i) {
  if (i >= n_paths) return 0;
  return elem_bytes == 4 ? static_cast<const int*>(mask)[i] != 0
                         : static_cast<const uint8_t*>(mask)[i] != 0;
}

// Rows of 0/1 path masks (one byte or one int32 per path, `n_paths` per
// row, row blockIdx.y) -> rows of n_words bit words, one ballot per
// warp. Launched ahead of each kernel on the same stream, so a query
// hands the raw masks over and packs them in one launch.
__global__ void __launch_bounds__(THREADS) pack_mask_kernel(
    const void* mask, int elem_bytes, int n_paths, int* words,
    int n_words) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const long long row = blockIdx.y;
  const void* row_mask =
      static_cast<const uint8_t*>(mask) + row * n_paths * elem_bytes;
  const unsigned w =
      __ballot_sync(0xFFFFFFFFu, raw_mask_bit(row_mask, elem_bytes, n_paths, i));
  if ((threadIdx.x & 31) == 0 && (i >> 5) < n_words) {
    words[row * n_words + (i >> 5)] = (int)w;
  }
}

// Packs `rows` masks into `words` (n_words = max(ceil(n_paths / 32), 1)
// per row).
void pack_mask(const void* mask, int elem_bytes, int n_paths, int rows,
               int* words, int n_words, cudaStream_t stream) {
  const dim3 grid((n_words * 32 + THREADS - 1) / THREADS, rows);
  pack_mask_kernel<<<grid, THREADS, 0, stream>>>(mask, elem_bytes, n_paths,
                                                 words, n_words);
}

// ---------------------------------------------------------------------
// The scan template (scan.cu, K6 and K8): an inclusive scan of an
// associative, not necessarily commutative, operator over n elements,
// each made from two int32 inputs (x[i], y[i]) and its position, writing
// two int32 outputs per element, in one launch that reads each input
// once (launch_scan_single, below).
//
// A thread takes SCAN_ITEMS consecutive elements (16-byte loads and
// stores where aligned), composes them in order, and a block-wide
// exclusive scan (warp shuffles, then one warp over the warp totals)
// orders the threads. An Op supplies:
//   using Agg = <struct of ints>;
//   static Agg identity();  static Agg combine(Agg a, Agg b);
//   Agg element(long long i, int x, int y, const int* words) const;
//   void emit(const Agg& prefix, int* o0, int* o1) const;  // inclusive
//   static int4 to_desc(const Agg& a, int flag);   // the look-back
//   static int from_desc(const int4& d, Agg& a);   // descriptor: flag
//                                                  // and Agg in 16 bytes
// and the members x, y, out0, out1, n, words, n_words.
// ---------------------------------------------------------------------

constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = THREADS * SCAN_ITEMS;  // elements per tile
constexpr int SCAN_SMEM_WORDS = 4096;  // 2^17 paths of mask bits (16 KB)

template <class T>
__device__ __forceinline__ T shfl_up_agg(const T& v, int d) {
  static_assert(sizeof(T) % 4 == 0, "aggregates are structs of ints");
  T out;
  const int* p = reinterpret_cast<const int*>(&v);
  int* q = reinterpret_cast<int*>(&out);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(T) / 4); ++k) {
    q[k] = __shfl_up_sync(0xFFFFFFFFu, p[k], d);
  }
  return out;
}

// Exclusive scan of one aggregate per thread, in thread order. `tot`
// holds 33 aggregates; *total gets the block's. Every thread calls it.
template <class Op, class T>
__device__ T block_exclusive_scan(T v, T* tot, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  T incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T o = shfl_up_agg(incl, d);
    if (lane >= d) incl = Op::combine(o, incl);
  }
  T excl = shfl_up_agg(incl, 1);
  if (lane == 0) excl = Op::identity();
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T t = lane < n_warps ? tot[lane] : Op::identity();
    T ti = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T o = shfl_up_agg(ti, d);
      if (lane >= d) ti = Op::combine(o, ti);
    }
    T te = shfl_up_agg(ti, 1);
    if (lane == 0) te = Op::identity();
    if (lane < n_warps) tot[lane] = te;
    if (lane == 31) tot[32] = ti;
  }
  __syncthreads();
  excl = Op::combine(tot[warp], excl);
  *total = tot[32];
  __syncthreads();  // `tot` may be reused by the next call
  return excl;
}

// The thread's SCAN_ITEMS inputs of the tile at `base`.
template <class Op>
__device__ __forceinline__ void load_items(const Op& op, long long base,
                                           int (&x)[SCAN_ITEMS],
                                           int (&y)[SCAN_ITEMS]) {
  const long long i0 = base + (long long)threadIdx.x * SCAN_ITEMS;
  const bool vec = i0 + SCAN_ITEMS <= op.n &&
                   ((reinterpret_cast<uintptr_t>(op.x) |
                     reinterpret_cast<uintptr_t>(op.y)) & 15u) == 0;
  if (vec) {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; j += 4) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(op.x + i0 + j));
      const int4 b = __ldg(reinterpret_cast<const int4*>(op.y + i0 + j));
      x[j] = a.x; x[j + 1] = a.y; x[j + 2] = a.z; x[j + 3] = a.w;
      y[j] = b.x; y[j + 1] = b.y; y[j + 2] = b.z; y[j + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const bool in = i0 + j < op.n;
      x[j] = in ? __ldg(op.x + i0 + j) : 0;
      y[j] = in ? __ldg(op.y + i0 + j) : 0;
    }
  }
}

// The aggregate of the thread's items of the tile at `base`.
template <class Op>
__device__ __forceinline__ typename Op::Agg thread_aggregate(
    const Op& op, long long base, const int (&x)[SCAN_ITEMS],
    const int (&y)[SCAN_ITEMS], const int* words) {
  const long long i0 = base + (long long)threadIdx.x * SCAN_ITEMS;
  typename Op::Agg acc = Op::identity();
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    if (i0 + j < op.n) acc = Op::combine(acc, op.element(i0 + j, x[j], y[j],
                                                          words));
  }
  return acc;
}

// Writes the outputs of the thread's items of the tile at `base`; `p`
// is the exclusive prefix of its first item.
template <class Op>
__device__ __forceinline__ void emit_items(const Op& op, long long base,
                                           const int (&x)[SCAN_ITEMS],
                                           const int (&y)[SCAN_ITEMS],
                                           const int* w,
                                           typename Op::Agg p) {
  const long long i0 = base + (long long)threadIdx.x * SCAN_ITEMS;
  int o0[SCAN_ITEMS], o1[SCAN_ITEMS];
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    if (i0 + j < op.n) p = Op::combine(p, op.element(i0 + j, x[j], y[j], w));
    op.emit(p, &o0[j], &o1[j]);
  }
  const bool vec = i0 + SCAN_ITEMS <= op.n &&
                   ((reinterpret_cast<uintptr_t>(op.out0) |
                     reinterpret_cast<uintptr_t>(op.out1)) & 15u) == 0;
  if (vec) {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; j += 4) {
      *reinterpret_cast<int4*>(op.out0 + i0 + j) =
          make_int4(o0[j], o0[j + 1], o0[j + 2], o0[j + 3]);
      *reinterpret_cast<int4*>(op.out1 + i0 + j) =
          make_int4(o1[j], o1[j + 1], o1[j + 2], o1[j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      if (i0 + j < op.n) {
        op.out0[i0 + j] = o0[j];
        op.out1[i0 + j] = o1[j];
      }
    }
  }
}

// ---------------------------------------------------------------------
// Single-pass scan with decoupled look-back (Merrill & Garland, "Single-
// pass Parallel Prefix Scan with Decoupled Look-back", 2016). Each turn
// a persistent block takes the next partition (one tile, SCAN_TILE
// elements) from a global counter (atomicAdd), scans it, and publishes
// its aggregate (FLAG_AGG) and then its inclusive prefix (FLAG_PREFIX).
// Its exclusive prefix comes from the predecessors: one warp reads 32
// descriptors at a time, waits until each is set, and combines them from
// the nearest inclusive prefix on, in order (the operator need not
// commute). A block waits only on lower tickets, which blocks already
// running hold, so the scan cannot deadlock whatever the scheduler does;
// the grid size changes speed, never the answer.
//
// A descriptor is 16 bytes that hold the flag and the aggregate together
// (Op::to_desc / Op::from_desc), stored and loaded as one 16-byte access
// (st/ld.relaxed.gpu.v4, as CUB's tile descriptors), so a reader never
// sees a flag without its payload and neither side needs a fence. A
// release store or an acquire fence would wait for the warp's
// outstanding stores, three times a partition, on the look-back's path.
//
// A reader polls until a descriptor decodes as FLAG_AGG or FLAG_PREFIX;
// any other flag (0 from the reset, or a value a read torn between two
// stores could decode to) counts as not ready. Op::from_desc may return
// 0 for a read whose parts disagree (K8's descriptor does).
//
// Scratch of n elements (single_scan_scratch_bytes): the ticket counter
// (16 bytes), then one descriptor a partition. The launch zeroes it with
// cudaMemsetAsync on its own stream (flag 0: not ready), so every call,
// and every replay of a captured CUDA graph, starts from a reset.
//
// The mask: with at most FOLD_WORDS bit words (8,192 paths) each block
// ballots the raw 0/1 mask into shared memory itself, so the call is the
// memset and one kernel; past that one pack_mask launch packs the words
// once ahead of the scan (a block reading 2^17 raw mask bytes would cost
// more than the launch), and blocks stage them (up to SCAN_SMEM_WORDS)
// or read them from global memory.
// ---------------------------------------------------------------------

// Blocks an SM holds (at most 48 registers a thread): partitions in
// flight hide the look-back's waits.
constexpr int SINGLE_MIN_BLOCKS = 5;
constexpr int FLAG_AGG = 1;
constexpr int FLAG_PREFIX = 2;
constexpr long long SCAN_HEADER_BYTES = 16;
constexpr int FOLD_WORDS = 256;

__device__ __forceinline__ bool desc_ready(int flag) {
  return flag == FLAG_AGG || flag == FLAG_PREFIX;
}

// The raw 0/1 mask (`elem_bytes` 1 or 4 per path) as n_words bit words in
// shared memory, one ballot per warp. Every thread of the block calls it;
// n_words * 32 is a multiple of the warp, so each warp's lanes loop
// together.
__device__ __forceinline__ const int* stage_raw_mask(
    int* s_words, const void* mask, int elem_bytes, int n_paths,
    int n_words) {
  for (int i = threadIdx.x; i < n_words * 32; i += blockDim.x) {
    const unsigned b =
        __ballot_sync(0xFFFFFFFFu, raw_mask_bit(mask, elem_bytes, n_paths, i));
    if ((threadIdx.x & 31) == 0) s_words[i >> 5] = (int)b;
  }
  __syncthreads();
  return s_words;
}

inline long long single_scan_parts(long long n) {
  return (n + SCAN_TILE - 1) / SCAN_TILE;
}

inline long long single_scan_scratch_bytes(long long n) {
  return SCAN_HEADER_BYTES + single_scan_parts(n) * (long long)sizeof(int4);
}

__device__ __forceinline__ void st_desc(int4* p, int4 v) {
  asm volatile("st.relaxed.gpu.global.v4.b32 [%0], {%1, %2, %3, %4};\n" ::
                   "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ int4 ld_desc(const int4* p) {
  int4 v;
  asm volatile("ld.relaxed.gpu.global.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

// Lane + d's aggregate (d > 0), or lane 0's (d == 0).
template <class T>
__device__ __forceinline__ T shfl_down_agg(const T& v, int d) {
  T out;
  const int* p = reinterpret_cast<const int*>(&v);
  int* q = reinterpret_cast<int*>(&out);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(T) / 4); ++k) {
    q[k] = d ? __shfl_down_sync(0xFFFFFFFFu, p[k], d)
             : __shfl_sync(0xFFFFFFFFu, p[k], 0);
  }
  return out;
}

// Publishes partition `part`'s aggregate and returns its exclusive
// prefix (in every lane). Called by one whole warp, part >= 1.
template <class Op>
__device__ typename Op::Agg look_back(int part, const typename Op::Agg& total,
                                      int4* desc) {
  using Agg = typename Op::Agg;
  const int lane = threadIdx.x & 31;
  if (lane == 0) st_desc(desc + part, Op::to_desc(total, FLAG_AGG));
  Agg run = Op::identity();  // the predecessors combined so far
  for (int end = part;; end -= 32) {
    // Lane l reads predecessor end - 1 - l: lower lanes come later.
    const int p = end - 1 - lane;
    Agg v = Op::identity();
    int flag = p < 0 ? FLAG_PREFIX : 0;
    while (__any_sync(0xFFFFFFFFu, !desc_ready(flag))) {
      if (!desc_ready(flag)) flag = Op::from_desc(ld_desc(desc + p), v);
    }
    const unsigned pre = __ballot_sync(0xFFFFFFFFu, flag == FLAG_PREFIX);
    const int stop = pre ? __ffs(pre) - 1 : 31;  // nearest inclusive prefix
    if (lane > stop) v = Op::identity();
    // Lane 0 gets v[stop] + ... + v[0], the window in sequence order.
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Agg o = shfl_down_agg(v, d);
      if (lane + d < 32) v = Op::combine(o, v);
    }
    run = Op::combine(shfl_down_agg(v, 0), run);
    if (pre) return run;  // partition 0 is always FLAG_PREFIX
  }
}

template <class Op>
__global__ void __launch_bounds__(THREADS, SINGLE_MIN_BLOCKS)
    scan_single(Op op, int parts, int* counter, int4* desc, const void* raw,
                int elem_bytes, int n_paths) {
  using Agg = typename Op::Agg;
  __shared__ int s_words[SCAN_SMEM_WORDS];
  __shared__ Agg s_tot[33];
  __shared__ Agg s_prefix;
  __shared__ int s_part;
  // raw: fold the mask packing in (n_words <= FOLD_WORDS); else the
  // words pack_mask wrote.
  const int* w =
      raw != nullptr
          ? stage_raw_mask(s_words, raw, elem_bytes, n_paths, op.n_words)
          : stage_words(s_words, op.words, op.n_words, SCAN_SMEM_WORDS);
  // A ticket is taken only when the block can start on it: a ticket held
  // while its block finishes another partition stalls every later one.
  for (;;) {
    if (threadIdx.x == 0) s_part = atomicAdd(counter, 1);
    __syncthreads();
    const int part = s_part;
    if (part >= parts) break;  // block-uniform
    const long long base = (long long)part * SCAN_TILE;
    int x[SCAN_ITEMS], y[SCAN_ITEMS];
    load_items(op, base, x, y);
    Agg total;
    const Agg excl = block_exclusive_scan<Op>(
        thread_aggregate(op, base, x, y, w), s_tot, &total);
    if (threadIdx.x < 32) {
      const Agg prefix =
          part == 0 ? Op::identity() : look_back<Op>(part, total, desc);
      if (threadIdx.x == 0) {
        st_desc(desc + part, Op::to_desc(Op::combine(prefix, total),
                                         FLAG_PREFIX));
        s_prefix = prefix;
      }
    }
    __syncthreads();
    emit_items(op, base, x, y, w, Op::combine(s_prefix, excl));
  }
}

// A single-pass scan on `stream`: the reset of its scratch, then (past
// FOLD_WORDS mask words) pack_mask of the raw mask into op.words, then
// the scan. `mask` holds n_paths entries of `elem_bytes` each.
template <class Op>
cudaError_t launch_scan_single(const Op& op, const void* mask,
                               int elem_bytes, int n_paths, void* scratch,
                               cudaStream_t stream) {
  const long long parts = single_scan_parts(op.n);
  if (parts <= 0) return cudaSuccess;
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, single_scan_scratch_bytes(op.n), stream);
  if (err != cudaSuccess) return err;
  const bool fold = op.n_words <= FOLD_WORDS;
  if (!fold) {
    pack_mask(mask, elem_bytes, n_paths, 1, const_cast<int*>(op.words),
              op.n_words, stream);
  }
  // Blocks resident on the card at once, found on the first call (before
  // any graph capture). Any count gives the same answer.
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_single<Op>,
                                                  THREADS, 0);
    resident = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  char* base = static_cast<char*>(scratch);
  scan_single<Op><<<(int)(parts < resident ? parts : resident), THREADS, 0,
                    stream>>>(op, (int)parts, reinterpret_cast<int*>(base),
                              reinterpret_cast<int4*>(base + SCAN_HEADER_BYTES),
                              fold ? mask : nullptr, elem_bytes, n_paths);
  return cudaGetLastError();
}

}  // namespace
