/* Demo of the C API (reference analogue: flatgfa-c/example/example.c).
 *
 * Build:
 *   g++ -O3 -shared -fPIC -std=c++17 -o libpollen_capi.so capi.cpp gfa_scan.cpp
 *   cc example.c -o example -L. -lpollen_capi -Wl,-rpath,'$ORIGIN'
 */

#include <stdio.h>

#include "pollen_capi.h"

int main(int argc, char **argv) {
  if (argc != 2) {
    fprintf(stderr, "usage: %s graph.gfa\n", argv[0]);
    return 1;
  }
  FlatGFAHandle *g = flatgfa_parse(argv[1]);
  if (!g) {
    fprintf(stderr, "parse failed\n");
    return 1;
  }

  printf("segments: %zu\n", flatgfa_get_segment_count(g));
  for (size_t i = 0; i < flatgfa_get_segment_count(g); ++i) {
    size_t len;
    const char *seq = flatgfa_get_seq(g, i, &len);
    printf("  seg %zu: %.*s\n", i, (int)len, seq);
  }

  printf("paths: %zu\n", flatgfa_path_count(g));
  for (size_t p = 0; p < flatgfa_path_count(g); ++p) {
    size_t len;
    const char *name = flatgfa_get_path_name(g, p, &len);
    printf("  %.*s:", (int)len, name);
    for (size_t s = 0; s < flatgfa_get_path_step_count(g, p); ++s) {
      uint32_t h = flatgfa_get_step(g, p, s);
      printf(" %u%c", h >> 1, (h & 1) ? '-' : '+');
    }
    printf("\n");
  }

  flatgfa_free(g);
  return 0;
}
