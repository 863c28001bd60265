// Fast numeric-table writer for multiclust-tpu output files.
//
// The reference emits its per-K estimate files with per-value fprintf
// loops (write_file_detail, write_file.c:203-335).  At biobank scale the
// .pklm table is K * sum_l M_l ~ 20M rows and the engine REWRITES the
// best-so-far files every time an initialization improves the maximum
// (multiclust.c:584-600) - a pure-Python formatting loop is far slower
// than the snprintf loop here, whose output is byte-identical
// ("%d"/"%f" semantics are shared with Python's % operator).
//
// C ABI + ctypes (no pybind11): one call writes header + table + trailer.
//   ints   row-major [n_rows, n_int]  int64  - leading tab-separated cols
//   floats row-major [n_rows, n_f]    double - trailing "%f" cols
// Row format: "<i0>\t<i1>...\t<f0>\t<f1>...\n".
//
// Build: make -C native   (produces _table_writer.so)

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Returns 0 on success; 1-3 on IO failure; 4 when a formatted field
// exceeds the width cap (value out of the writer's supported range).
int mc_write_table(const char* path, const char* header,
                   const char* trailer, int64_t n_rows, int32_t n_int,
                   const int64_t* ints, int32_t n_f,
                   const double* floats) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return 1;
  static const size_t BUF = 1 << 20;
  // per-field width cap; snprintf's return value is the UNtruncated
  // length.  A field that does not fit (a double >= ~1e41 under "%f")
  // would silently lose digits and diverge from the byte-identical
  // Python fallback, so it is a distinct error (rc=4) rather than a
  // clamp.  Flush whenever the remaining slack cannot hold
  // a full worst-case row.
  static const size_t FIELD = 48;
  const size_t row_max = (size_t)(n_int + n_f) * (FIELD + 1) + 2;
  char* buf = new char[BUF + row_max];
  size_t used = 0;
  int rc = 0;

  if (header && *header) {
    if (fwrite(header, 1, strlen(header), fp) != strlen(header)) rc = 2;
  }
  for (int64_t r = 0; r < n_rows && rc == 0; ++r) {
    char* w = buf + used;
    for (int32_t c = 0; c < n_int; ++c) {
      if (c) *w++ = '\t';
      int n = snprintf(w, FIELD, "%lld", (long long)ints[r * n_int + c]);
      if (n < 0 || (size_t)n >= FIELD) { rc = 4; break; }
      w += (size_t)n;
    }
    for (int32_t c = 0; c < n_f && rc == 0; ++c) {
      if (c || n_int) *w++ = '\t';
      int n = snprintf(w, FIELD, "%f", floats[r * n_f + c]);
      if (n < 0 || (size_t)n >= FIELD) { rc = 4; break; }
      w += (size_t)n;
    }
    if (rc != 0) break;
    *w++ = '\n';
    used = (size_t)(w - buf);
    if (used + row_max >= BUF) {
      if (fwrite(buf, 1, used, fp) != used) rc = 2;
      used = 0;
    }
  }
  if (rc == 0 && used) {
    if (fwrite(buf, 1, used, fp) != used) rc = 2;
  }
  if (rc == 0 && trailer && *trailer) {
    if (fwrite(trailer, 1, strlen(trailer), fp) != strlen(trailer))
      rc = 2;
  }
  delete[] buf;
  if (fclose(fp) != 0) rc = 3;
  return rc;
}

}  // extern "C"
