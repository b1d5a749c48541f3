// Native graph-builder runtime: the port's copy of
// lgcnhs_tpu/native/graph_builder.cc.
//
// The reference builds all graph structures with Python row loops over pandas
// frames (utils/trans.py:13-116) and dense torch round-trips
// (utils/graph.py:12-50). This library supplies the host-side heavy lifting
// for large catalogs: raw CSV edge parsing and CSR construction with edge
// dedup, O(E) over caller-provided buffers.
// Exposed via a C ABI for ctypes (no pybind11 needed).
//
// Build (native/bindings.py does it at first use):
//   g++ -O3 -march=native -shared -fPIC graph_builder.cc -o _build/libgraph_builder.so
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Parse "user<sep>item<sep>..." integer rows from a CSV/TSV file into edge
// arrays. Skips a header line if the first field is non-numeric. Returns the
// number of edges parsed, -1 on open failure, or -2 if capacity is too small.
int64_t parse_edges_csv(const char* path, char sep, int32_t* users,
                        int32_t* items, int64_t capacity) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  const size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  buf[got] = '\0';

  const char* p = buf.data();
  const char* end = buf.data() + got;
  int64_t n = 0;
  while (p < end) {
    // locate end of line
    const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!eol) eol = end;
    if (*p >= '0' && *p <= '9') {
      // parse first two integer fields
      int64_t u = 0, it = 0;
      const char* q = p;
      while (q < eol && *q >= '0' && *q <= '9') u = u * 10 + (*q++ - '0');
      if (q < eol && *q == sep) {
        ++q;
        const char* r = q;
        while (r < eol && *r >= '0' && *r <= '9') it = it * 10 + (*r++ - '0');
        if (r > q) {
          if (n >= capacity) return -2;
          users[n] = static_cast<int32_t>(u);
          items[n] = static_cast<int32_t>(it);
          ++n;
        }
      }
    }
    p = eol + 1;
  }
  return n;
}

// Parse "user<sep>item<sep>rating<sep>timestamp" integer rows with a
// MULTI-CHARACTER separator (ML-1M's "::", ML-100K's "\t", plain ","). Skips
// lines whose first byte is non-numeric (headers). Returns rows parsed, -1 on
// open failure, -2 if capacity is too small, -3 on a malformed numeric row.
int64_t parse_rating_rows(const char* path, const char* sep, int32_t* users,
                          int32_t* items, int32_t* ratings, int32_t* times,
                          int64_t capacity) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  const size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  buf[got] = '\0';

  const size_t sep_len = std::strlen(sep);
  const char* p = buf.data();
  const char* end = buf.data() + got;
  int64_t n = 0;
  while (p < end) {
    const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!eol) eol = end;
    if (*p >= '0' && *p <= '9') {
      int64_t field[4] = {0, 0, 0, 0};
      const char* q = p;
      bool ok = true;
      for (int c = 0; c < 4 && ok; ++c) {
        const char* start = q;
        while (q < eol && *q >= '0' && *q <= '9')
          field[c] = field[c] * 10 + (*q++ - '0');
        if (q == start || field[c] > INT32_MAX) { ok = false; break; }
        if (c < 3) {
          if (q + sep_len <= eol && std::memcmp(q, sep, sep_len) == 0)
            q += sep_len;
          else
            ok = false;
        }
      }
      if (!ok) return -3;
      if (n >= capacity) return -2;
      users[n] = static_cast<int32_t>(field[0]);
      items[n] = static_cast<int32_t>(field[1]);
      ratings[n] = static_cast<int32_t>(field[2]);
      times[n] = static_cast<int32_t>(field[3]);
      ++n;
    }
    p = eol + 1;
  }
  return n;
}

// Build a deduplicated CSR from COO edges.
//   indptr: caller-allocated (n_rows + 1) int64
//   indices: caller-allocated (n_edges) int32 (dedup count <= n_edges)
// Returns the deduplicated edge count.
int64_t build_csr(const int32_t* rows, const int32_t* cols, int64_t n_edges,
                  int32_t n_rows, int64_t* indptr, int32_t* indices) {
  // counting sort by row
  std::vector<int64_t> count(static_cast<size_t>(n_rows) + 1, 0);
  for (int64_t e = 0; e < n_edges; ++e) ++count[rows[e] + 1];
  for (int32_t r = 0; r < n_rows; ++r) count[r + 1] += count[r];
  std::vector<int32_t> sorted_cols(n_edges);
  {
    std::vector<int64_t> cursor(count.begin(), count.end() - 1);
    for (int64_t e = 0; e < n_edges; ++e)
      sorted_cols[cursor[rows[e]]++] = cols[e];
  }
  // per-row sort + dedup
  int64_t out_n = 0;
  indptr[0] = 0;
  for (int32_t r = 0; r < n_rows; ++r) {
    int32_t* lo = sorted_cols.data() + count[r];
    int32_t* hi = sorted_cols.data() + count[r + 1];
    std::sort(lo, hi);
    int32_t* last = std::unique(lo, hi);
    for (int32_t* p = lo; p < last; ++p) indices[out_n++] = *p;
    indptr[r + 1] = out_n;
  }
  return out_n;
}

}  // extern "C"
