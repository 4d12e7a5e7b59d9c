// Fast Matrix Market coordinate-file parser.
//
// Native-code counterpart of the framework's Python loader
// (sparsematrixmultiplicationmpi_jax/io/mtx.py), replacing the reference
// loader's hot path ("Source Code/utils.cpp:70-185": whole-file iostream
// extraction, O(nnz) single-threaded) with an mmap-free buffered read and
// multithreaded hand-rolled number parsing. Exposes a C ABI consumed via
// ctypes (io/native.py) — no pybind11 dependency.
//
// Semantics match the Python loader exactly:
//   * '%' comment lines before the size header are substring-scanned for
//     the tokens "symmetric" and "pattern";
//   * size header is "rows cols nnz";
//   * entries are 1-based "row col [value]" lines; pattern files carry no
//     value column (value := 1.0).
// Symmetric mirroring and CSR construction stay in vectorized numpy — the
// text->COO conversion is the part that needs native speed.

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Chunk {
  const char* begin;
  const char* end;
  std::vector<int32_t> rows;
  std::vector<int32_t> cols;
  std::vector<double> vals;
  bool ok = true;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) ++p;
  return p;
}

inline const char* parse_i32(const char* p, const char* end, int32_t* out,
                             bool* ok) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '+' || *p == '-')) neg = (*p++ == '-');
  if (p >= end || !isdigit((unsigned char)*p)) {
    *ok = false;
    return p;
  }
  int64_t v = 0;
  while (p < end && isdigit((unsigned char)*p)) v = v * 10 + (*p++ - '0');
  *out = (int32_t)(neg ? -v : v);
  return p;
}

inline const char* parse_f64(const char* p, const char* end, double* out,
                             bool* ok) {
  p = skip_ws(p, end);
  if (p >= end) {
    *ok = false;
    return p;
  }
  char* q = nullptr;
  // strtod is correctly rounded; the buffer is NUL-terminated by caller.
  *out = strtod(p, &q);
  if (q == p) {
    *ok = false;
    return p;
  }
  return q;
}

void parse_chunk(Chunk* c, bool pattern) {
  const char* p = c->begin;
  const char* end = c->end;
  while (true) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '%') {  // stray comment among data: skip the line
      while (p < end && *p != '\n') ++p;
      continue;
    }
    int32_t r, col;
    double v = 1.0;
    bool ok = true;
    p = parse_i32(p, end, &r, &ok);
    p = parse_i32(p, end, &col, &ok);
    if (!pattern) p = parse_f64(p, end, &v, &ok);
    if (!ok) {
      c->ok = false;
      return;
    }
    c->rows.push_back(r - 1);  // 1-based -> 0-based (utils.cpp:143-144)
    c->cols.push_back(col - 1);
    c->vals.push_back(v);
  }
}

}  // namespace

extern "C" {

struct MMResult {
  int64_t rows = 0;
  int64_t cols = 0;
  int64_t nnz = 0;          // entries actually parsed
  int64_t declared_nnz = 0; // header value
  int32_t symmetric = 0;
  int32_t pattern = 0;
  int32_t ok = 0;
  int32_t* row_idx = nullptr;
  int32_t* col_idx = nullptr;
  double* values = nullptr;
  char error[256] = {0};
};

MMResult* mm_read(const char* path, int n_threads) {
  auto* res = new MMResult();
  FILE* f = fopen(path, "rb");
  if (!f) {
    snprintf(res->error, sizeof(res->error), "Unable to open file: %s", path);
    return res;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(size + 1);
  if (size > 0 && fread(&buf[0], 1, size, f) != (size_t)size) {
    fclose(f);
    snprintf(res->error, sizeof(res->error), "Failed to read file: %s", path);
    return res;
  }
  fclose(f);
  buf[size] = '\0';

  const char* p = buf.data();
  const char* end = buf.data() + size;

  // Header: comment lines scanned for tokens (utils.cpp:84-105), then
  // "rows cols nnz".
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    const char* q = skip_ws(p, line_end);
    if (q < line_end && *q == '%') {
      std::string line(p, line_end - p);
      if (line.find("symmetric") != std::string::npos) res->symmetric = 1;
      if (line.find("pattern") != std::string::npos) res->pattern = 1;
      p = line_end + 1;
      continue;
    }
    if (q == line_end) {  // blank line
      p = line_end + 1;
      continue;
    }
    break;
  }
  {
    bool ok = true;
    int32_t r = 0, c = 0, nz = 0;
    p = parse_i32(p, end, &r, &ok);
    p = parse_i32(p, end, &c, &ok);
    p = parse_i32(p, end, &nz, &ok);
    if (!ok) {
      snprintf(res->error, sizeof(res->error),
               "Failed to read matrix dimensions from file: %s", path);
      return res;
    }
    res->rows = r;
    res->cols = c;
    res->declared_nnz = nz;
    while (p < end && *p != '\n') ++p;  // to start of body
  }

  // Split the body at line boundaries for parallel parsing.
  if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  int64_t body = end - p;
  if (body < (1 << 20)) n_threads = 1;  // small file: no thread overhead

  std::vector<Chunk> chunks(n_threads);
  const char* start = p;
  for (int t = 0; t < n_threads; ++t) {
    const char* cb = start + body * t / n_threads;
    const char* ce = start + body * (t + 1) / n_threads;
    if (t > 0) {  // advance to next line boundary
      while (cb < end && *cb != '\n') ++cb;
      if (cb < end) ++cb;
    }
    if (t < n_threads - 1) {
      while (ce < end && *ce != '\n') ++ce;
      if (ce < end) ++ce;
    } else {
      ce = end;
    }
    chunks[t].begin = cb;
    chunks[t].end = ce;
  }
  // Chunk boundaries are monotone; overlapping degenerate chunks are empty.
  for (int t = 1; t < n_threads; ++t)
    if (chunks[t].begin < chunks[t - 1].end) chunks[t].begin = chunks[t - 1].end;

  bool pattern = res->pattern != 0;
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t)
    threads.emplace_back(parse_chunk, &chunks[t], pattern);
  parse_chunk(&chunks[0], pattern);
  for (auto& th : threads) th.join();

  int64_t total = 0;
  for (auto& c : chunks) {
    if (!c.ok) {
      snprintf(res->error, sizeof(res->error),
               "Failed to read data from file: %s", path);
      return res;
    }
    total += (int64_t)c.rows.size();
  }
  if (total < res->declared_nnz) {
    snprintf(res->error, sizeof(res->error),
             "Failed to read data from file: %s (expected %lld entries, got %lld)",
             path, (long long)res->declared_nnz, (long long)total);
    return res;
  }
  total = res->declared_nnz;  // ignore trailing garbage beyond header count

  res->row_idx = (int32_t*)malloc(total * sizeof(int32_t));
  res->col_idx = (int32_t*)malloc(total * sizeof(int32_t));
  res->values = (double*)malloc(total * sizeof(double));
  int64_t off = 0;
  for (auto& c : chunks) {
    int64_t take = (int64_t)c.rows.size();
    if (off + take > total) take = total - off;
    if (take <= 0) break;
    memcpy(res->row_idx + off, c.rows.data(), take * sizeof(int32_t));
    memcpy(res->col_idx + off, c.cols.data(), take * sizeof(int32_t));
    memcpy(res->values + off, c.vals.data(), take * sizeof(double));
    off += take;
  }
  res->nnz = total;
  res->ok = 1;
  return res;
}

void mm_free(MMResult* res) {
  if (!res) return;
  free(res->row_idx);
  free(res->col_idx);
  free(res->values);
  delete res;
}

}  // extern "C"
