/* C API for the pollen-tpu flat GFA arena.
 *
 * Reference analogue: flatgfa-c's cbindgen-generated header. Strings
 * are pointer + length, NOT NUL-terminated. A packed step is
 * (segment_id << 1) | orientation, orientation 1 = reverse.
 */

#ifndef POLLEN_CAPI_H
#define POLLEN_CAPI_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct FlatGFAHandle FlatGFAHandle;

/* Parse a GFA text file; NULL on failure. */
FlatGFAHandle *flatgfa_parse(const char *filename);

/* Release a handle and all associated memory. */
void flatgfa_free(FlatGFAHandle *h);

size_t flatgfa_get_segment_count(const FlatGFAHandle *h);

/* Sequence bytes of segment `seg` (0-based id). */
const char *flatgfa_get_seq(const FlatGFAHandle *h, size_t seg, size_t *len);

size_t flatgfa_path_count(const FlatGFAHandle *h);

const char *flatgfa_get_path_name(const FlatGFAHandle *h, size_t path,
                                  size_t *len);

size_t flatgfa_get_path_step_count(const FlatGFAHandle *h, size_t path);

/* Packed handle of step `idx` of path `path`. */
uint32_t flatgfa_get_step(const FlatGFAHandle *h, size_t path, size_t idx);

#ifdef __cplusplus
}
#endif

#endif /* POLLEN_CAPI_H */
