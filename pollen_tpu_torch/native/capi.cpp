// C ABI over the flat GFA arena (reference analogue: flatgfa-c).
//
// Exposes the same eight entry points as the reference's cdylib
// (reference: flatgfa-c/src/lib.rs:60-172): parse/free plus accessors
// for segments, sequences, paths, names, and packed steps. Strings are
// returned as pointer + length (not NUL-terminated).
//
// Build (with the scanner in the same library):
//   g++ -O3 -shared -fPIC -std=c++17 -o libpollen_capi.so capi.cpp gfa_scan.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "pollen_capi.h"

// From gfa_scan.cpp.
extern "C" {
struct GfaOut;
int gfa_parse(const uint8_t *buf, uint64_t len, struct GfaOut *out);
void gfa_free(struct GfaOut *out);
}

// Mirror of the scanner's output struct (kept in sync with
// gfa_scan.cpp).
struct GfaOut {
  uint64_t n_segs;
  int64_t *seg_name;
  uint32_t *seg_seq;
  uint32_t *seg_opt;
  uint64_t n_paths;
  uint32_t *path_name;
  uint32_t *path_steps;
  uint32_t *path_olaps;
  uint64_t n_links;
  uint32_t *link_from;
  uint32_t *link_to;
  uint32_t *link_olap;
  uint64_t n_steps;
  uint32_t *steps;
  uint64_t n_seq;
  uint8_t *seq_data;
  uint64_t n_overlaps;
  uint32_t *overlaps;
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

struct FlatGFAHandle {
  GfaOut out;
};

extern "C" {

FlatGFAHandle *flatgfa_parse(const char *filename) {
  FILE *f = fopen(filename, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  uint8_t *buf = static_cast<uint8_t *>(malloc(size > 0 ? size : 1));
  size_t got = fread(buf, 1, static_cast<size_t>(size), f);
  fclose(f);
  if (static_cast<long>(got) != size) {
    free(buf);
    return nullptr;
  }

  FlatGFAHandle *h = new FlatGFAHandle();
  int code = gfa_parse(buf, static_cast<uint64_t>(size), &h->out);
  free(buf);
  if (code != 0) {
    delete h;
    return nullptr;
  }
  return h;
}

void flatgfa_free(FlatGFAHandle *h) {
  if (!h) return;
  gfa_free(&h->out);
  delete h;
}

size_t flatgfa_get_segment_count(const FlatGFAHandle *h) {
  return h->out.n_segs;
}

const char *flatgfa_get_seq(const FlatGFAHandle *h, size_t seg,
                            size_t *len) {
  if (seg >= h->out.n_segs) {
    *len = 0;
    return nullptr;
  }
  uint32_t lo = h->out.seg_seq[seg * 2];
  uint32_t hi = h->out.seg_seq[seg * 2 + 1];
  *len = hi - lo;
  return reinterpret_cast<const char *>(h->out.seq_data) + lo;
}

size_t flatgfa_path_count(const FlatGFAHandle *h) { return h->out.n_paths; }

const char *flatgfa_get_path_name(const FlatGFAHandle *h, size_t path,
                                  size_t *len) {
  if (path >= h->out.n_paths) {
    *len = 0;
    return nullptr;
  }
  uint32_t lo = h->out.path_name[path * 2];
  uint32_t hi = h->out.path_name[path * 2 + 1];
  *len = hi - lo;
  return reinterpret_cast<const char *>(h->out.name_data) + lo;
}

size_t flatgfa_get_path_step_count(const FlatGFAHandle *h, size_t path) {
  if (path >= h->out.n_paths) return 0;
  return h->out.path_steps[path * 2 + 1] - h->out.path_steps[path * 2];
}

uint32_t flatgfa_get_step(const FlatGFAHandle *h, size_t path, size_t idx) {
  uint32_t lo = h->out.path_steps[path * 2];
  return h->out.steps[lo + idx];
}

}  // extern "C"
