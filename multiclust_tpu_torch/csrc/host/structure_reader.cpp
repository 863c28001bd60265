// Fast STRUCTURE-format tokenizer for multiclust-tpu.
//
// The reference parses with per-character fgetc/fscanf loops
// (read_file.c:169-238) - fine for its era, but a 100k x 500k biobank
// STRUCTURE file is ~200 GB of text where parsing dominates end-to-end
// time AND no single host can materialize the parse.  This reader
// STREAMS the file in fixed-size chunks (bounded memory regardless of
// file size) and supports three entry points:
//
//   mc_scan_structure(path)
//     metadata pass: data-row count, header width, the first two row
//     names (interleave autodetect needs them, read_file.c:89-95) -
//     numeric payloads are never materialized.
//   mc_parse_structure_range(path, lo, hi)
//     materialize only data rows [lo, hi) - the per-process ingestion
//     primitive for multi-host runs (each process parses its own row
//     range; parsing STOPS at hi, so process p reads ~p/P of the file's
//     bytes and materializes only its shard).
//   mc_parse_structure(path) == mc_parse_structure_range(path, 0, -1).
//
// Emits the numeric genotype matrix as int64 [n_rows, n_cols] plus a
// NUL-separated blob of the two leading info tokens per row (name,
// locale), decoded lazily on the Python side.  Layout interpretation
// (interleave detection, ploidy reshaping, missing remap) stays in
// Python where it is cheap.  C ABI + ctypes - no pybind11.
//
// Build: make -C native   (produces _structure_reader.so)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

struct McParse {
  int64_t n_rows;        // data rows MATERIALIZED (in [lo, hi))
  int64_t n_cols;        // numeric columns per data row
  int64_t header_cols;   // tokens on the header line
  int32_t skipped_distances;  // a "-1 ..." second line was skipped
  int32_t error;         // nonzero on failure
  char err_msg[256];
  int64_t* data;         // [n_rows * n_cols]
  char* blob;            // name\0locale\0 per row
  int64_t blob_len;
};

struct McScan {
  int64_t n_rows;        // total data rows in the file
  int64_t header_cols;
  int32_t skipped_distances;
  int32_t error;
  char err_msg[256];
  char name0[256];       // names of the first two data rows (interleave
  char name1[256];       // autodetect, read_file.c:89-95); empty if absent
};

static void fail_p(McParse* p, const char* msg) {
  p->error = 1;
  snprintf(p->err_msg, sizeof(p->err_msg), "%s", msg);
}

static void fail_s(McScan* s, const char* msg) {
  s->error = 1;
  snprintf(s->err_msg, sizeof(s->err_msg), "%s", msg);
}

// Streaming line reader: fixed 8 MB read chunks, lines assembled across
// chunk boundaries in a carry buffer - memory is O(chunk + longest line),
// never O(file).
class LineStream {
 public:
  explicit LineStream(FILE* f) : f_(f), pos_(0), len_(0), eof_(false) {
    buf_.resize(kChunk);
  }

  // Returns false at EOF.  *line/*line_len expose the next line (no \n);
  // the pointer is valid until the next call.
  bool next(const char** line, size_t* line_len) {
    carry_.clear();
    for (;;) {
      if (pos_ >= len_) {
        if (eof_) {
          if (carry_.empty()) return false;
          *line = carry_.data();
          *line_len = carry_.size();
          return true;
        }
        len_ = fread(buf_.data(), 1, kChunk, f_);
        pos_ = 0;
        if (len_ < kChunk) eof_ = true;
        if (len_ == 0) continue;
      }
      const char* start = buf_.data() + pos_;
      const char* nl = (const char*)memchr(start, '\n', len_ - pos_);
      if (nl) {
        size_t n = (size_t)(nl - start);
        pos_ += n + 1;
        if (carry_.empty()) {
          *line = start;
          *line_len = n;
        } else {
          carry_.append(start, n);
          *line = carry_.data();
          *line_len = carry_.size();
        }
        return true;
      }
      carry_.append(start, len_ - pos_);
      pos_ = len_;
    }
  }

 private:
  static const size_t kChunk = 8u << 20;
  FILE* f_;
  std::string buf_;
  std::string carry_;
  size_t pos_, len_;
  bool eof_;
};

struct Tok {
  const char* p;
  size_t len;
};

// Split a line into whitespace-separated tokens; returns token count.
static size_t tokenize(const char* line, size_t len, std::vector<Tok>* out) {
  out->clear();
  const char* t = line;
  const char* end = line + len;
  while (t < end) {
    while (t < end && (*t == ' ' || *t == '\t' || *t == '\r')) ++t;
    if (t >= end) break;
    const char* tok = t;
    while (t < end && *t != ' ' && *t != '\t' && *t != '\r') ++t;
    out->push_back({tok, (size_t)(t - tok)});
  }
  return out->size();
}

// Count tokens only (scan pass: no vector churn).
static size_t count_tokens(const char* line, size_t len, bool* any) {
  const char* t = line;
  const char* end = line + len;
  size_t n = 0;
  while (t < end) {
    while (t < end && (*t == ' ' || *t == '\t' || *t == '\r')) ++t;
    if (t >= end) break;
    ++n;
    while (t < end && *t != ' ' && *t != '\t' && *t != '\r') ++t;
  }
  *any = n > 0;
  return n;
}

static bool is_distance_line(const char* line, size_t len) {
  const char* t = line;
  const char* end = line + len;
  while (t < end && (*t == ' ' || *t == '\t' || *t == '\r')) ++t;
  return end - t >= 2 && t[0] == '-' && t[1] == '1'
      && (end - t == 2 || t[2] == ' ' || t[2] == '\t' || t[2] == '\r');
}

McScan* mc_scan_structure(const char* path) {
  McScan* s = (McScan*)calloc(1, sizeof(McScan));
  if (!s) return nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) { fail_s(s, "cannot open file"); return s; }
  LineStream ls(f);
  const char* line;
  size_t len;
  bool header_done = false;
  bool first_data = true;
  std::vector<Tok> toks;
  while (ls.next(&line, &len)) {
    bool any;
    if (!header_done) {
      size_t n = count_tokens(line, len, &any);
      if (!any) continue;
      s->header_cols = (int64_t)n;
      header_done = true;
      continue;
    }
    if (first_data && is_distance_line(line, len)) {
      s->skipped_distances = 1;
      first_data = false;
      continue;
    }
    if (s->n_rows < 2) {
      tokenize(line, len, &toks);
      if (toks.empty()) continue;
      char* dst = s->n_rows == 0 ? s->name0 : s->name1;
      size_t n = toks[0].len < 255 ? toks[0].len : 255;
      memcpy(dst, toks[0].p, n);
      dst[n] = '\0';
    } else {
      count_tokens(line, len, &any);
      if (!any) continue;
    }
    first_data = false;
    s->n_rows += 1;
  }
  fclose(f);
  if (!header_done) fail_s(s, "empty file");
  return s;
}

McParse* mc_parse_structure_range(const char* path, int64_t lo, int64_t hi) {
  McParse* p = (McParse*)calloc(1, sizeof(McParse));
  if (!p) return nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) { fail_p(p, "cannot open file"); return p; }

  std::vector<int64_t> data;
  std::string blob;
  data.reserve(1 << 20);
  blob.reserve(1 << 16);

  LineStream ls(f);
  const char* line;
  size_t len;
  bool header_done = false;
  bool first_data = true;
  int64_t row_idx = 0;   // data-row ordinal in the file
  int64_t n_cols = -1;
  std::vector<Tok> toks;

  while (ls.next(&line, &len)) {
    if (!header_done) {
      bool any;
      size_t n = count_tokens(line, len, &any);
      if (!any) continue;
      p->header_cols = (int64_t)n;
      header_done = true;
      continue;
    }
    if (first_data && is_distance_line(line, len)) {
      p->skipped_distances = 1;
      first_data = false;
      continue;
    }
    first_data = false;
    bool in_range = row_idx >= lo && (hi < 0 || row_idx < hi);
    if (!in_range) {
      bool any;
      count_tokens(line, len, &any);
      if (!any) continue;
      ++row_idx;
      if (hi >= 0 && row_idx >= hi) break;  // nothing left to read
      continue;
    }
    tokenize(line, len, &toks);
    if (toks.empty()) continue;
    if (toks.size() < 2) {
      fclose(f);
      fail_p(p, "row with fewer than 2 info columns");
      return p;
    }
    int64_t row_cols = 0;
    for (size_t ti = 2; ti < toks.size(); ++ti) {
      // fast integer parse (alleles are integers, read_file.c:32)
      const char* q = toks[ti].p;
      const char* qe = q + toks[ti].len;
      bool neg = false;
      int64_t v = 0;
      if (q < qe && *q == '-') { neg = true; ++q; }
      if (q == qe) { fclose(f); fail_p(p, "non-integer allele token"); return p; }
      for (; q < qe; ++q) {
        if (*q < '0' || *q > '9') {
          fclose(f); fail_p(p, "non-integer allele token"); return p;
        }
        v = v * 10 + (*q - '0');
      }
      data.push_back(neg ? -v : v);
      ++row_cols;
    }
    if (n_cols < 0) n_cols = row_cols;
    else if (row_cols != n_cols) {
      fclose(f); fail_p(p, "ragged data rows"); return p;
    }
    blob.append(toks[0].p, toks[0].len); blob.push_back('\0');
    blob.append(toks[1].p, toks[1].len); blob.push_back('\0');
    p->n_rows += 1;
    ++row_idx;
    if (hi >= 0 && row_idx >= hi) break;
  }
  fclose(f);

  p->n_cols = n_cols < 0 ? 0 : n_cols;
  p->data = (int64_t*)malloc(data.size() * sizeof(int64_t));
  if (!p->data && !data.empty()) { fail_p(p, "out of memory"); return p; }
  memcpy(p->data, data.data(), data.size() * sizeof(int64_t));
  p->blob_len = (int64_t)blob.size();
  p->blob = (char*)malloc(blob.size());
  if (!p->blob && !blob.empty()) { fail_p(p, "out of memory"); return p; }
  memcpy(p->blob, blob.data(), blob.size());
  return p;
}

McParse* mc_parse_structure(const char* path) {
  return mc_parse_structure_range(path, 0, -1);
}

void mc_free(McParse* p) {
  if (!p) return;
  free(p->data);
  free(p->blob);
  free(p);
}

void mc_free_scan(McScan* s) {
  free(s);
}

}  // extern "C"
