// Fast multithreaded GFA tokenizer producing the flat arena pools.
//
// Native-code counterpart of pollen_tpu/flatgfa.py::parse_gfa (reference
// analogue: the Rust flatgfa parser, flatgfa/src/{gfaline,parse}.rs, and
// its rayon-parallel newline splitting, flatgfa/src/memfile.rs:33-117).
// The output arrays are bit-identical to the NumPy parser's pools; any
// input this scanner cannot handle returns a nonzero code and the
// caller falls back to the NumPy path (which produces real errors).
//
// Parallel structure: the buffer splits at newline boundaries into
// ordered shards. Phase 1 tokenizes lines into per-shard record
// vectors (+ byte counts for the variable pools). Phase 2 materializes
// each shard's pools — byte pools write straight into the final
// buffers at precomputed offsets; index pools build shard-locally and
// are rebased by scalar adds during the ordered merge, so the result
// is byte-identical to the single-shard parse.
//
// Build: g++ -O3 -shared -fPIC -pthread -o libpollen_scan.so gfa_scan.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct Span32 {
  uint32_t lo, hi;
};

struct SegRec {
  int64_t name;
  const uint8_t *seq_lo, *seq_hi;
  const uint8_t *opt_lo, *opt_hi;
};

struct LinkRec {
  int64_t from_name, to_name;
  uint8_t from_rev, to_rev;
  const uint8_t *cig_lo, *cig_hi;
};

struct PathRec {
  const uint8_t *name_lo, *name_hi;
  const uint8_t *steps_lo, *steps_hi;
  const uint8_t *olap_lo, *olap_hi;
};

// Parse a decimal integer in [p, end); returns false on empty/garbage.
inline bool parse_u64(const uint8_t *p, const uint8_t *end, int64_t *out) {
  if (p >= end) return false;
  int64_t v = 0;
  for (; p < end; ++p) {
    if (*p < '0' || *p > '9') return false;
    v = v * 10 + (*p - '0');
  }
  *out = v;
  return true;
}

inline const uint8_t *find_tab(const uint8_t *p, const uint8_t *end) {
  return static_cast<const uint8_t *>(
      memchr(p, '\t', static_cast<size_t>(end - p)));
}

inline int op_code(uint8_t c) {
  switch (c) {
    case 'M': return 0;
    case 'N': return 1;
    case 'D': return 2;
    case 'I': return 3;
    default: return -1;
  }
}

// Parse one CIGAR string, appending packed (count << 8 | op) words.
// "*" appends nothing. Returns false on malformed input.
bool parse_cigar(const uint8_t *lo, const uint8_t *hi,
                 std::vector<uint32_t> *pool) {
  if (hi - lo == 1 && *lo == '*') return true;
  const uint8_t *p = lo;
  while (p < hi) {
    int64_t count = 0;
    bool digits = false;
    while (p < hi && *p >= '0' && *p <= '9') {
      count = count * 10 + (*p - '0');
      ++p;
      digits = true;
    }
    if (!digits || p >= hi) return false;
    int code = op_code(*p);
    if (code < 0) return false;
    pool->push_back(static_cast<uint32_t>(count) << 8 |
                    static_cast<uint32_t>(code));
    ++p;
  }
  return true;
}

template <typename T>
T *copy_out(const std::vector<T> &v) {
  T *p = static_cast<T *>(malloc(v.size() * sizeof(T) + 1));
  if (!v.empty()) memcpy(p, v.data(), v.size() * sizeof(T));
  return p;
}

// All pools of one parsed graph, still in host vectors (shared between
// the copy-out ABI below and the direct-to-file converter).
struct Pools {
  std::vector<int64_t> seg_name;
  std::vector<uint32_t> seg_seq, seg_opt;
  std::vector<uint32_t> path_name, path_steps, path_olaps;
  std::vector<uint32_t> link_from, link_to, link_olap;
  std::vector<uint32_t> steps, overlaps, alignment;
  std::vector<uint8_t> seq_data, opt_data, name_data, line_order;
  const uint8_t *header_lo = nullptr, *header_hi = nullptr;
};

}  // namespace

extern "C" {

struct GfaOut {
  uint64_t n_segs;
  int64_t *seg_name;
  uint32_t *seg_seq;   // 2 per seg
  uint32_t *seg_opt;   // 2 per seg
  uint64_t n_paths;
  uint32_t *path_name;   // 2 per path
  uint32_t *path_steps;  // 2 per path
  uint32_t *path_olaps;  // 2 per path
  uint64_t n_links;
  uint32_t *link_from;
  uint32_t *link_to;
  uint32_t *link_olap;  // 2 per link
  uint64_t n_steps;
  uint32_t *steps;
  uint64_t n_seq;
  uint8_t *seq_data;
  uint64_t n_overlaps;
  uint32_t *overlaps;  // 2 per entry
  uint64_t n_align;
  uint32_t *alignment;
  uint64_t n_name_data;
  uint8_t *name_data;
  uint64_t n_opt_data;
  uint8_t *opt_data;
  uint64_t n_lines;
  uint8_t *line_order;
  uint64_t n_header;
  uint8_t *header;
};

int gfa_parse(const uint8_t *buf, uint64_t len, GfaOut *out);

}  // extern "C"

namespace {

// One byte-range of the input: phase-1 line records, phase-2 local
// pools. Shards are ordered, so concatenating their outputs reproduces
// the serial parse exactly.
struct Shard {
  // Phase 1: tokenized records + byte counts for the data pools.
  std::vector<SegRec> segs;
  std::vector<LinkRec> links;
  std::vector<PathRec> paths;
  std::vector<uint8_t> line_order;
  const uint8_t *header_lo = nullptr, *header_hi = nullptr;
  int err = 0;
  uint64_t seq_bytes = 0, opt_bytes = 0, name_bytes = 0;

  // Phase-2 bases (set between phases).
  uint64_t seq_base = 0, opt_base = 0, name_base = 0;

  // Phase 2: shard-local pools. seg_seq/seg_opt/path_name hold final
  // absolute offsets (their bases are known up front); the rest are
  // local and rebased by scalar adds in the merge.
  std::vector<int64_t> seg_name;
  std::vector<uint32_t> seg_seq, seg_opt;
  std::vector<uint32_t> link_from, link_to, link_olap;
  std::vector<uint32_t> l_overlaps, l_alignment;  // link CIGAR pools
  std::vector<uint32_t> path_name, path_steps, path_olaps;
  std::vector<uint32_t> steps;
  std::vector<uint32_t> p_overlaps, p_alignment;  // path CIGAR pools
};

// Phase 1: tokenize [lo, hi) into records. Field pointers reference
// the input buffer; nothing is copied yet.
void scan_lines(const uint8_t *lo, const uint8_t *hi, Shard *sh) {
  const uint8_t *p = lo;
  while (p < hi) {
    const uint8_t *nl = static_cast<const uint8_t *>(
        memchr(p, '\n', static_cast<size_t>(hi - p)));
    const uint8_t *end = nl ? nl : hi;
    if (end == p) {  // blank line
      p = end + 1;
      continue;
    }
    uint8_t kind = *p;
    if (end - p < 2 || p[1] != '\t') {
      sh->err = 1;
      return;
    }
    const uint8_t *rest = p + 2;

    if (kind == 'H') {
      if (sh->header_lo) {
        sh->err = 2;  // multiple headers
        return;
      }
      sh->header_lo = rest;
      sh->header_hi = end;
      sh->line_order.push_back(0);
    } else if (kind == 'S') {
      const uint8_t *t1 = find_tab(rest, end);
      if (!t1) {
        sh->err = 3;
        return;
      }
      SegRec s;
      if (!parse_u64(rest, t1, &s.name)) {
        sh->err = 4;
        return;
      }
      const uint8_t *t2 = find_tab(t1 + 1, end);
      s.seq_lo = t1 + 1;
      s.seq_hi = t2 ? t2 : end;
      s.opt_lo = t2 ? t2 + 1 : end;
      s.opt_hi = end;
      sh->seq_bytes += static_cast<uint64_t>(s.seq_hi - s.seq_lo);
      sh->opt_bytes += static_cast<uint64_t>(s.opt_hi - s.opt_lo);
      sh->segs.push_back(s);
      sh->line_order.push_back(1);
    } else if (kind == 'L') {
      LinkRec l;
      const uint8_t *t1 = find_tab(rest, end);
      if (!t1 || !parse_u64(rest, t1, &l.from_name)) {
        sh->err = 5;
        return;
      }
      const uint8_t *t2 = find_tab(t1 + 1, end);
      if (!t2 || t2 - t1 != 2) {
        sh->err = 5;
        return;
      }
      if (t1[1] == '-') l.from_rev = 1;
      else if (t1[1] == '+') l.from_rev = 0;
      else {
        sh->err = 5;
        return;
      }
      const uint8_t *t3 = find_tab(t2 + 1, end);
      if (!t3 || !parse_u64(t2 + 1, t3, &l.to_name)) {
        sh->err = 5;
        return;
      }
      const uint8_t *t4 = find_tab(t3 + 1, end);
      if (!t4 || t4 - t3 != 2) {
        sh->err = 5;
        return;
      }
      if (t3[1] == '-') l.to_rev = 1;
      else if (t3[1] == '+') l.to_rev = 0;
      else {
        sh->err = 5;
        return;
      }
      l.cig_lo = t4 + 1;
      l.cig_hi = end;
      sh->links.push_back(l);
      sh->line_order.push_back(3);
    } else if (kind == 'P') {
      PathRec pr;
      const uint8_t *t1 = find_tab(rest, end);
      if (!t1) {
        sh->err = 6;
        return;
      }
      const uint8_t *t2 = find_tab(t1 + 1, end);
      if (!t2) {
        sh->err = 6;
        return;
      }
      const uint8_t *t3 = find_tab(t2 + 1, end);
      pr.name_lo = rest;
      pr.name_hi = t1;
      pr.steps_lo = t1 + 1;
      pr.steps_hi = t2;
      pr.olap_lo = t2 + 1;
      pr.olap_hi = t3 ? t3 : end;
      sh->name_bytes += static_cast<uint64_t>(pr.name_hi - pr.name_lo);
      sh->paths.push_back(pr);
      sh->line_order.push_back(2);
    } else {
      sh->err = 7;
      return;
    }
    p = end + 1;
  }
}

// Name map over all shards: sequential 1..N fast path, hash fallback.
struct NameMap {
  bool sequential = true;
  uint64_t n = 0;
  std::unordered_map<int64_t, uint32_t> map;

  bool lookup(int64_t name, uint32_t *id) const {
    if (sequential) {
      if (name < 1 || name > static_cast<int64_t>(n)) return false;
      *id = static_cast<uint32_t>(name - 1);
      return true;
    }
    auto it = map.find(name);
    if (it == map.end()) return false;
    *id = it->second;
    return true;
  }
};

// Phase 2: materialize one shard's pools. Byte pools (seq/opt/name)
// write straight into the final buffers at the shard's precomputed
// base; index pools build locally.
void materialize_shard(Shard *sh, const NameMap &nm, uint8_t *seq_out,
                       uint8_t *opt_out, uint8_t *name_out) {
  // Segments.
  const uint64_t n = sh->segs.size();
  sh->seg_name.resize(n);
  sh->seg_seq.resize(n * 2);
  sh->seg_opt.resize(n * 2);
  uint64_t seq_at = sh->seq_base, opt_at = sh->opt_base;
  for (uint64_t i = 0; i < n; ++i) {
    const SegRec &s = sh->segs[i];
    sh->seg_name[i] = s.name;
    const uint64_t s_len = static_cast<uint64_t>(s.seq_hi - s.seq_lo);
    const uint64_t o_len = static_cast<uint64_t>(s.opt_hi - s.opt_lo);
    sh->seg_seq[i * 2] = static_cast<uint32_t>(seq_at);
    memcpy(seq_out + seq_at, s.seq_lo, s_len);
    seq_at += s_len;
    sh->seg_seq[i * 2 + 1] = static_cast<uint32_t>(seq_at);
    sh->seg_opt[i * 2] = static_cast<uint32_t>(opt_at);
    memcpy(opt_out + opt_at, s.opt_lo, o_len);
    opt_at += o_len;
    sh->seg_opt[i * 2 + 1] = static_cast<uint32_t>(opt_at);
  }

  // Links: handles + CIGARs into the shard-local link pools.
  sh->link_from.reserve(sh->links.size());
  for (const LinkRec &l : sh->links) {
    uint32_t f, t;
    if (!nm.lookup(l.from_name, &f) || !nm.lookup(l.to_name, &t)) {
      sh->err = 8;
      return;
    }
    sh->link_from.push_back(f << 1 | l.from_rev);
    sh->link_to.push_back(t << 1 | l.to_rev);
    uint32_t a_lo = static_cast<uint32_t>(sh->l_alignment.size());
    if (!parse_cigar(l.cig_lo, l.cig_hi, &sh->l_alignment)) {
      sh->err = 9;
      return;
    }
    uint32_t entry = static_cast<uint32_t>(sh->l_overlaps.size() / 2);
    sh->l_overlaps.push_back(a_lo);
    sh->l_overlaps.push_back(static_cast<uint32_t>(sh->l_alignment.size()));
    sh->link_olap.push_back(entry);
    sh->link_olap.push_back(entry + 1);
  }

  // Paths: names (absolute), steps + CIGARs (local).
  uint64_t name_at = sh->name_base;
  for (const PathRec &pr : sh->paths) {
    const uint64_t n_len = static_cast<uint64_t>(pr.name_hi - pr.name_lo);
    sh->path_name.push_back(static_cast<uint32_t>(name_at));
    memcpy(name_out + name_at, pr.name_lo, n_len);
    name_at += n_len;
    sh->path_name.push_back(static_cast<uint32_t>(name_at));

    uint32_t s_lo = static_cast<uint32_t>(sh->steps.size());
    const uint8_t *q = pr.steps_lo;
    while (q < pr.steps_hi) {
      int64_t name = 0;
      bool digits = false;
      while (q < pr.steps_hi && *q >= '0' && *q <= '9') {
        name = name * 10 + (*q - '0');
        ++q;
        digits = true;
      }
      if (!digits || q >= pr.steps_hi) {
        sh->err = 10;
        return;
      }
      uint8_t rev;
      if (*q == '+') rev = 0;
      else if (*q == '-') rev = 1;
      else {
        sh->err = 10;
        return;
      }
      ++q;
      if (q < pr.steps_hi) {
        if (*q != ',') {
          sh->err = 10;
          return;
        }
        ++q;
      }
      uint32_t id;
      if (!nm.lookup(name, &id)) {
        sh->err = 11;
        return;
      }
      sh->steps.push_back(id << 1 | rev);
    }
    sh->path_steps.push_back(s_lo);
    sh->path_steps.push_back(static_cast<uint32_t>(sh->steps.size()));

    // Overlap column: '*' or comma-separated CIGARs. Link and path
    // CIGARs live in separate local pools here, so the global
    // link-then-path pool order falls out of the merge for free.
    uint32_t e_lo = static_cast<uint32_t>(sh->p_overlaps.size() / 2);
    if (!(pr.olap_hi - pr.olap_lo == 1 && *pr.olap_lo == '*')) {
      const uint8_t *c = pr.olap_lo;
      while (c < pr.olap_hi) {
        const uint8_t *comma = static_cast<const uint8_t *>(
            memchr(c, ',', static_cast<size_t>(pr.olap_hi - c)));
        const uint8_t *piece_end = comma ? comma : pr.olap_hi;
        uint32_t a_lo = static_cast<uint32_t>(sh->p_alignment.size());
        if (!parse_cigar(c, piece_end, &sh->p_alignment)) {
          sh->err = 12;
          return;
        }
        sh->p_overlaps.push_back(a_lo);
        sh->p_overlaps.push_back(
            static_cast<uint32_t>(sh->p_alignment.size()));
        c = comma ? comma + 1 : pr.olap_hi;
      }
    }
    sh->path_olaps.push_back(e_lo);
    sh->path_olaps.push_back(static_cast<uint32_t>(sh->p_overlaps.size() / 2));
  }
}

// Append ``src`` to ``dst`` with a scalar added to every element.
void append_rebased(std::vector<uint32_t> *dst,
                    const std::vector<uint32_t> &src, uint32_t base) {
  size_t at = dst->size();
  dst->resize(at + src.size());
  uint32_t *o = dst->data() + at;
  for (size_t i = 0; i < src.size(); ++i) o[i] = src[i] + base;
}

int pick_threads(uint64_t len) {
  const char *env = getenv("POLLEN_SCAN_THREADS");
  if (env && *env) {
    long v = strtol(env, nullptr, 10);
    if (v >= 1) return static_cast<int>(v > 64 ? 64 : v);
  }
  if (len < (4u << 20)) return 1;  // threads don't pay below ~4 MB
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t by_size = len / (2u << 20);
  uint64_t t = hw ? (hw < by_size ? hw : by_size) : 1;
  if (t < 1) t = 1;
  if (t > 32) t = 32;
  return static_cast<int>(t);
}

// Parse GFA text into pool vectors; returns 0 on success, else the
// error code gfa_parse reports (the caller falls back to NumPy).
int parse_pools(const uint8_t *buf, uint64_t len, Pools *P) {
  const int nt = pick_threads(len);

  // Shard boundaries: advance each split point to the next newline.
  std::vector<Shard> shards(nt);
  std::vector<const uint8_t *> starts(nt + 1);
  starts[0] = buf;
  starts[nt] = buf + len;
  for (int t = 1; t < nt; ++t) {
    const uint8_t *p = buf + len * static_cast<uint64_t>(t) / nt;
    const uint8_t *nl = static_cast<const uint8_t *>(
        memchr(p, '\n', static_cast<size_t>(buf + len - p)));
    starts[t] = nl ? nl + 1 : buf + len;
  }

  // Phase 1: tokenize shards in parallel.
  {
    std::vector<std::thread> threads;
    for (int t = 1; t < nt; ++t) {
      threads.emplace_back(scan_lines, starts[t], starts[t + 1], &shards[t]);
    }
    scan_lines(starts[0], starts[1], &shards[0]);
    for (auto &th : threads) th.join();
  }
  for (const Shard &sh : shards) {
    if (sh.err) return sh.err;  // earliest shard = earliest line
  }

  // Header: exactly one across the whole file (error 2 matches the
  // serial scan's "multiple headers").
  for (const Shard &sh : shards) {
    if (!sh.header_lo) continue;
    if (P->header_lo) return 2;
    P->header_lo = sh.header_lo;
    P->header_hi = sh.header_hi;
  }

  // Bases for the byte pools + the global name map.
  uint64_t n_segs = 0, seq_total = 0, opt_total = 0, name_total = 0;
  NameMap nm;
  for (Shard &sh : shards) {
    sh.seq_base = seq_total;
    sh.opt_base = opt_total;
    sh.name_base = name_total;
    seq_total += sh.seq_bytes;
    opt_total += sh.opt_bytes;
    name_total += sh.name_bytes;
    for (const SegRec &s : sh.segs) {
      if (nm.sequential && s.name != static_cast<int64_t>(n_segs) + 1) {
        nm.sequential = false;
      }
      ++n_segs;
    }
  }
  nm.n = n_segs;
  if (!nm.sequential) {
    nm.map.reserve(n_segs * 2);
    uint64_t i = 0;
    for (const Shard &sh : shards) {
      for (const SegRec &s : sh.segs) {
        nm.map.emplace(s.name, static_cast<uint32_t>(i++));
      }
    }
  }
  P->seq_data.resize(seq_total);
  P->opt_data.resize(opt_total);
  P->name_data.resize(name_total);

  // Phase 2: materialize shards in parallel.
  {
    std::vector<std::thread> threads;
    for (int t = 1; t < nt; ++t) {
      threads.emplace_back(materialize_shard, &shards[t], std::cref(nm),
                           P->seq_data.data(), P->opt_data.data(),
                           P->name_data.data());
    }
    materialize_shard(&shards[0], nm, P->seq_data.data(),
                      P->opt_data.data(), P->name_data.data());
    for (auto &th : threads) th.join();
  }
  for (const Shard &sh : shards) {
    if (sh.err) return sh.err;
  }

  // Ordered merge with scalar rebases. Global pool order: link CIGARs
  // (by shard) then path CIGARs (by shard) — identical to the serial
  // link-then-path deferral.
  uint64_t l_align_total = 0, l_over_total = 0;
  for (const Shard &sh : shards) {
    l_align_total += sh.l_alignment.size();
    l_over_total += sh.l_overlaps.size() / 2;
  }
  uint64_t steps_at = 0, l_align_at = 0, l_over_at = 0;
  uint64_t p_align_at = l_align_total, p_over_at = l_over_total;
  for (Shard &sh : shards) {
    for (int64_t v : sh.seg_name) P->seg_name.push_back(v);
    P->seg_seq.insert(P->seg_seq.end(), sh.seg_seq.begin(),
                      sh.seg_seq.end());
    P->seg_opt.insert(P->seg_opt.end(), sh.seg_opt.begin(),
                      sh.seg_opt.end());
    P->link_from.insert(P->link_from.end(), sh.link_from.begin(),
                        sh.link_from.end());
    P->link_to.insert(P->link_to.end(), sh.link_to.begin(),
                      sh.link_to.end());
    P->path_name.insert(P->path_name.end(), sh.path_name.begin(),
                        sh.path_name.end());
    P->steps.insert(P->steps.end(), sh.steps.begin(), sh.steps.end());
    append_rebased(&P->path_steps, sh.path_steps,
                   static_cast<uint32_t>(steps_at));
    steps_at += sh.steps.size();
    P->line_order.insert(P->line_order.end(), sh.line_order.begin(),
                         sh.line_order.end());
    // Link CIGAR pools.
    P->alignment.insert(P->alignment.end(), sh.l_alignment.begin(),
                        sh.l_alignment.end());
    append_rebased(&P->overlaps, sh.l_overlaps,
                   static_cast<uint32_t>(l_align_at));
    append_rebased(&P->link_olap, sh.link_olap,
                   static_cast<uint32_t>(l_over_at));
    l_align_at += sh.l_alignment.size();
    l_over_at += sh.l_overlaps.size() / 2;
  }
  // Path CIGAR pools land after every link's.
  for (Shard &sh : shards) {
    P->alignment.insert(P->alignment.end(), sh.p_alignment.begin(),
                        sh.p_alignment.end());
    append_rebased(&P->overlaps, sh.p_overlaps,
                   static_cast<uint32_t>(p_align_at));
    append_rebased(&P->path_olaps, sh.path_olaps,
                   static_cast<uint32_t>(p_over_at));
    p_align_at += sh.p_alignment.size();
    p_over_at += sh.p_overlaps.size() / 2;
  }
  return 0;
}

}  // namespace

extern "C" {

int gfa_parse(const uint8_t *buf, uint64_t len, GfaOut *out) {
  Pools P;
  int code = parse_pools(buf, len, &P);
  if (code != 0) return code;
  out->n_segs = P.seg_name.size();
  out->seg_name = copy_out(P.seg_name);
  out->seg_seq = copy_out(P.seg_seq);
  out->seg_opt = copy_out(P.seg_opt);
  out->n_paths = P.path_name.size() / 2;
  out->path_name = copy_out(P.path_name);
  out->path_steps = copy_out(P.path_steps);
  out->path_olaps = copy_out(P.path_olaps);
  out->n_links = P.link_from.size();
  out->link_from = copy_out(P.link_from);
  out->link_to = copy_out(P.link_to);
  out->link_olap = copy_out(P.link_olap);
  out->n_steps = P.steps.size();
  out->steps = copy_out(P.steps);
  out->n_seq = P.seq_data.size();
  out->seq_data = copy_out(P.seq_data);
  out->n_overlaps = P.overlaps.size() / 2;
  out->overlaps = copy_out(P.overlaps);
  out->n_align = P.alignment.size();
  out->alignment = copy_out(P.alignment);
  out->n_name_data = P.name_data.size();
  out->name_data = copy_out(P.name_data);
  out->n_opt_data = P.opt_data.size();
  out->opt_data = copy_out(P.opt_data);
  out->n_lines = P.line_order.size();
  out->line_order = copy_out(P.line_order);
  out->n_header =
      P.header_lo ? static_cast<uint64_t>(P.header_hi - P.header_lo) : 0;
  if (P.header_lo) {
    uint8_t *h = static_cast<uint8_t *>(malloc(out->n_header + 1));
    memcpy(h, P.header_lo, out->n_header);
    out->header = h;
  } else {
    out->header = static_cast<uint8_t *>(malloc(1));
  }
  return 0;
}

void gfa_free(GfaOut *out) {
  free(out->seg_name);
  free(out->seg_seq);
  free(out->seg_opt);
  free(out->path_name);
  free(out->path_steps);
  free(out->path_olaps);
  free(out->link_from);
  free(out->link_to);
  free(out->link_olap);
  free(out->steps);
  free(out->seq_data);
  free(out->overlaps);
  free(out->alignment);
  free(out->name_data);
  free(out->opt_data);
  free(out->line_order);
  free(out->header);
}

// Parse GFA text and write the binary FlatGFA file directly — the
// reference's `prealloc_translate` fast path (cli/main.rs:216-248):
// no Python-side pool materialization, one pass from text to file.
// TOC layout matches pollen_tpu/fileformat.py (magic + 11 (len, cap)
// u64 pairs, pools padded to capacity). `spare` reserves extra
// capacity per pool for later in-place mutation. Returns 0 on success,
// the gfa_parse error codes on parse failure, or 100+code on IO error.
int gfa_convert(const uint8_t *buf, uint64_t len, const char *out_path,
                double spare) {
  Pools P;
  int code = parse_pools(buf, len, &P);
  if (code != 0) return code;

  const uint64_t n = P.seg_name.size();
  const uint64_t p = P.path_name.size() / 2;
  const uint64_t l = P.link_from.size();

  // Assemble the AoS record pools (segs 24 B, paths 24 B, links 16 B).
  std::vector<uint8_t> segs(n * 24);
  for (uint64_t i = 0; i < n; ++i) {
    uint8_t *r = segs.data() + i * 24;
    uint64_t name = static_cast<uint64_t>(P.seg_name[i]);
    memcpy(r, &name, 8);
    memcpy(r + 8, &P.seg_seq[i * 2], 8);
    memcpy(r + 16, &P.seg_opt[i * 2], 8);
  }
  std::vector<uint8_t> paths(p * 24);
  for (uint64_t i = 0; i < p; ++i) {
    uint8_t *r = paths.data() + i * 24;
    memcpy(r, &P.path_name[i * 2], 8);
    memcpy(r + 8, &P.path_steps[i * 2], 8);
    memcpy(r + 16, &P.path_olaps[i * 2], 8);
  }
  std::vector<uint8_t> links(l * 16);
  for (uint64_t i = 0; i < l; ++i) {
    uint8_t *r = links.data() + i * 16;
    memcpy(r, &P.link_from[i], 4);
    memcpy(r + 4, &P.link_to[i], 4);
    memcpy(r + 8, &P.link_olap[i * 2], 8);
  }

  const uint64_t header_len =
      P.header_lo ? static_cast<uint64_t>(P.header_hi - P.header_lo) : 0;

  struct PoolDesc {
    const void *data;
    uint64_t len;   // element count
    uint64_t elem;  // element size in bytes
  };
  const PoolDesc pools[11] = {
      {P.header_lo, header_len, 1},
      {segs.data(), n, 24},
      {paths.data(), p, 24},
      {links.data(), l, 16},
      {P.steps.data(), P.steps.size(), 4},
      {P.seq_data.data(), P.seq_data.size(), 1},
      {P.overlaps.data(), P.overlaps.size() / 2, 8},
      {P.alignment.data(), P.alignment.size(), 4},
      {P.name_data.data(), P.name_data.size(), 1},
      {P.opt_data.data(), P.opt_data.size(), 1},
      {P.line_order.data(), P.line_order.size(), 1},
  };

  uint64_t toc[23];
  toc[0] = 0xB1011054ull;  // magic
  uint64_t total = sizeof(toc);
  uint64_t offsets[11];
  for (int i = 0; i < 11; ++i) {
    uint64_t cap =
        pools[i].len + static_cast<uint64_t>(pools[i].len * spare);
    toc[1 + 2 * i] = pools[i].len;
    toc[2 + 2 * i] = cap;
    offsets[i] = total;
    total += cap * pools[i].elem;
  }

  int fd = open(out_path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return 100;
  if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
    close(fd);
    return 101;
  }
  bool ok = pwrite(fd, toc, sizeof(toc), 0) ==
            static_cast<ssize_t>(sizeof(toc));
  for (int i = 0; ok && i < 11; ++i) {
    uint64_t nbytes = pools[i].len * pools[i].elem;
    uint64_t done = 0;
    while (ok && done < nbytes) {
      ssize_t w = pwrite(fd, static_cast<const uint8_t *>(pools[i].data) + done,
                         nbytes - done, static_cast<off_t>(offsets[i] + done));
      if (w <= 0) ok = false;
      else done += static_cast<uint64_t>(w);
    }
  }
  if (close(fd) != 0) ok = false;
  return ok ? 0 : 102;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Emitter: pools -> GFA text (preserved line order).
//
// Native counterpart of pollen_tpu/emit.py::emit_gfa(order="preserved");
// a parse -> emit round trip through this pair is byte-identical.
// ---------------------------------------------------------------------------

namespace {

inline void put_u64(std::vector<uint8_t> *out, int64_t v) {
  char tmp[24];
  int n = 0;
  if (v == 0) {
    tmp[n++] = '0';
  } else {
    while (v > 0) {
      tmp[n++] = static_cast<char>('0' + v % 10);
      v /= 10;
    }
  }
  while (n > 0) out->push_back(static_cast<uint8_t>(tmp[--n]));
}

inline void put_bytes(std::vector<uint8_t> *out, const uint8_t *p, size_t n) {
  out->insert(out->end(), p, p + n);
}

// Append one CIGAR rendering for the overlap-pool entry range
// [e_lo, e_hi); `empty` is used when the range has no entries.
void put_cigars(std::vector<uint8_t> *out, const GfaOut &g, uint32_t e_lo,
                uint32_t e_hi, const char *empty) {
  static const char kOps[] = "MNDI";
  if (e_lo >= e_hi) {
    while (*empty) out->push_back(static_cast<uint8_t>(*empty++));
    return;
  }
  for (uint32_t e = e_lo; e < e_hi; ++e) {
    if (e > e_lo) out->push_back(',');
    uint32_t a_lo = g.overlaps[e * 2], a_hi = g.overlaps[e * 2 + 1];
    if (a_lo == a_hi) {
      out->push_back('0');
      out->push_back('M');
      continue;
    }
    for (uint32_t a = a_lo; a < a_hi; ++a) {
      uint32_t op = g.alignment[a];
      put_u64(out, op >> 8);
      out->push_back(static_cast<uint8_t>(kOps[op & 0xff]));
    }
  }
}

}  // namespace

namespace {

// Render lines [lo, hi) of the preserved order into ``out``; si/pi/li
// are the segment/path/link cursors at line ``lo``. Returns false on a
// corrupt line_order byte.
bool emit_lines(const GfaOut *g, uint64_t lo, uint64_t hi, uint64_t si,
                uint64_t pi, uint64_t li, std::vector<uint8_t> *outp) {
  std::vector<uint8_t> &out = *outp;
  for (uint64_t i = lo; i < hi; ++i) {
    switch (g->line_order[i]) {
      case 0:  // header
        put_bytes(&out, reinterpret_cast<const uint8_t *>("H\t"), 2);
        put_bytes(&out, g->header, g->n_header);
        break;
      case 1: {  // segment
        const uint64_t s = si++;
        put_bytes(&out, reinterpret_cast<const uint8_t *>("S\t"), 2);
        put_u64(&out, g->seg_name[s]);
        out.push_back('\t');
        put_bytes(&out, g->seq_data + g->seg_seq[s * 2],
                  g->seg_seq[s * 2 + 1] - g->seg_seq[s * 2]);
        uint32_t o_lo = g->seg_opt[s * 2], o_hi = g->seg_opt[s * 2 + 1];
        if (o_hi > o_lo) {
          out.push_back('\t');
          put_bytes(&out, g->opt_data + o_lo, o_hi - o_lo);
        }
        break;
      }
      case 2: {  // path
        const uint64_t p = pi++;
        put_bytes(&out, reinterpret_cast<const uint8_t *>("P\t"), 2);
        put_bytes(&out, g->name_data + g->path_name[p * 2],
                  g->path_name[p * 2 + 1] - g->path_name[p * 2]);
        out.push_back('\t');
        uint32_t lo = g->path_steps[p * 2], hi = g->path_steps[p * 2 + 1];
        for (uint32_t s = lo; s < hi; ++s) {
          if (s > lo) out.push_back(',');
          uint32_t h = g->steps[s];
          put_u64(&out, g->seg_name[h >> 1]);
          out.push_back((h & 1) ? '-' : '+');
        }
        out.push_back('\t');
        put_cigars(&out, *g, g->path_olaps[p * 2], g->path_olaps[p * 2 + 1],
                   "*");
        break;
      }
      case 3: {  // link
        const uint64_t l = li++;
        put_bytes(&out, reinterpret_cast<const uint8_t *>("L\t"), 2);
        uint32_t f = g->link_from[l], t = g->link_to[l];
        put_u64(&out, g->seg_name[f >> 1]);
        out.push_back('\t');
        out.push_back((f & 1) ? '-' : '+');
        out.push_back('\t');
        put_u64(&out, g->seg_name[t >> 1]);
        out.push_back('\t');
        out.push_back((t & 1) ? '-' : '+');
        out.push_back('\t');
        put_cigars(&out, *g, g->link_olap[l * 2], g->link_olap[l * 2 + 1],
                   "0M");
        break;
      }
      default:
        return false;
    }
    out.push_back('\n');
  }
  return true;
}

}  // namespace

extern "C" {

// Render the arena as GFA text in preserved line order, sharded over
// line ranges (per-shard segment/path/link cursors come from a prefix
// count of line_order, so shard outputs concatenate to exactly the
// serial rendering). The returned buffer is malloc'd; the caller frees
// it with gfa_text_free.
uint8_t *gfa_emit(const GfaOut *g, uint64_t *out_len) {
  const uint64_t est = g->n_seq + g->n_name_data +
                       24 * (g->n_segs + g->n_links + g->n_lines) +
                       8 * g->n_steps;
  const int nt = pick_threads(est);

  // Estimated render COST per line — lines vary over 5+ orders of
  // magnitude (a pangenome P line renders megabytes), so shards
  // balance by weight, not line count. Steps cost ~6x their rendered
  // bytes (digit loops vs the S lines' straight memcpy), hence the
  // per-step factor.
  auto line_weight = [g](uint8_t kind, uint64_t si, uint64_t pi) -> uint64_t {
    switch (kind) {
      case 1:
        return 8 + g->seg_seq[si * 2 + 1] - g->seg_seq[si * 2];
      case 2:
        return 16 +
               48 * static_cast<uint64_t>(g->path_steps[pi * 2 + 1] -
                                          g->path_steps[pi * 2]);
      case 3:
        return 96;
      default:
        return 8 + g->n_header;
    }
  };
  uint64_t total_w = 0;
  {
    uint64_t si = 0, pi = 0;
    for (uint64_t i = 0; i < g->n_lines; ++i) {
      uint8_t k = g->line_order[i];
      total_w += line_weight(k, si, pi);
      si += (k == 1);
      pi += (k == 2);
    }
  }

  std::vector<std::vector<uint8_t>> parts(nt);
  // One char per shard: vector<bool> packs bits and is not safe for
  // concurrent writes to distinct elements.
  std::vector<char> ok(nt, 1);
  std::vector<std::thread> threads;
  uint64_t si = 0, pi = 0, li = 0, at = 0, w_at = 0;
  for (int t = 0; t < nt; ++t) {
    const uint64_t lo = at;
    const uint64_t w_target = total_w * static_cast<uint64_t>(t + 1) / nt;
    uint64_t s0 = si, p0 = pi, l0 = li;
    const uint64_t w_before = w_at;
    uint64_t hi = lo;
    while (hi < g->n_lines && (w_at < w_target || t == nt - 1)) {
      uint8_t k = g->line_order[hi];
      w_at += line_weight(k, si, pi);
      si += (k == 1);
      pi += (k == 2);
      li += (k == 3);
      ++hi;
    }
    parts[t].reserve(w_at - w_before + 64);
    if (t == nt - 1) {
      ok[t] = emit_lines(g, lo, hi, s0, p0, l0, &parts[t]);
    } else {
      threads.emplace_back([g, lo, hi, s0, p0, l0, t, &parts, &ok] {
        ok[t] = emit_lines(g, lo, hi, s0, p0, l0, &parts[t]);
      });
    }
    at = hi;
  }
  for (auto &th : threads) th.join();
  for (int t = 0; t < nt; ++t) {
    if (!ok[t]) {
      *out_len = 0;
      return nullptr;
    }
  }

  uint64_t total = 0;
  for (const auto &p : parts) total += p.size();
  uint8_t *buf = static_cast<uint8_t *>(malloc(total + 1));
  uint64_t off = 0;
  for (const auto &p : parts) {
    memcpy(buf + off, p.data(), p.size());
    off += p.size();
  }
  *out_len = total;
  return buf;
}

void gfa_text_free(uint8_t *buf) { free(buf); }

// Render the arena as GFA text straight into ``out_path`` — the
// emit-bound transform path (chop/crush/flip...) skips the Python
// string round trip entirely. Returns 0 on success, 1 on corrupt
// line_order, 100+ on IO errors.
int gfa_emit_file(const GfaOut *g, const char *out_path) {
  uint64_t len = 0;
  uint8_t *buf = gfa_emit(g, &len);
  if (!buf) return 1;
  int fd = open(out_path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) {
    free(buf);
    return 100;
  }
  uint64_t done = 0;
  bool ok = true;
  while (ok && done < len) {
    ssize_t w = write(fd, buf + done, len - done);
    if (w <= 0) ok = false;
    else done += static_cast<uint64_t>(w);
  }
  if (close(fd) != 0) ok = false;
  free(buf);
  return ok ? 0 : 101;
}

}  // extern "C"
