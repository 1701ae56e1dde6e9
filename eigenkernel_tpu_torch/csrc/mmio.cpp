// MatrixMarket coordinate parser, built with g++ and loaded with ctypes
// (io/native_mm.py).
//
// The port's copy of the JAX package's native/mmio.cpp reader: the file is
// read whole into one buffer, and the "i j [value]" lines are parsed in one
// pass with strtol/strtod on the buffer (no allocation a line), the
// counterpart of the reference's hand-written value loop
// (matrix_io.f90:91-144).  A pattern file ("i j" lines) gets the value 1.

#include <cstdint>
#include <cstdio>
#include <cstdlib>

namespace {

// p past one line (the character after '\n', or end).
const char* skip_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
    ++p;
  return p;
}

// Parse a long at p; false if there is none.
bool take_long(const char*& p, long* out) {
  char* q;
  *out = std::strtol(p, &q, 10);
  if (q == p) return false;
  p = q;
  return true;
}

}  // namespace

// Parse the entries of a MatrixMarket coordinate file into rows, cols
// (int64, 0-based) and vals (float64), arrays of nnz_expected entries;
// pattern != 0 for a pattern file.  Returns the entries parsed, or -1 (the
// file cannot be read), -2 (no banner or size line), -3 (a malformed
// entry), -4 (more entries than nnz_expected).
extern "C" int64_t ek_mm_read_coordinate(const char* path,
                                         int64_t nnz_expected, int pattern,
                                         int64_t* rows, int64_t* cols,
                                         double* vals) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size <= 0) {
    std::fclose(f);
    return -1;
  }
  char* buf = static_cast<char*>(std::malloc(static_cast<size_t>(size) + 1));
  if (!buf) {
    std::fclose(f);
    return -1;
  }
  const size_t got = std::fread(buf, 1, static_cast<size_t>(size), f);
  std::fclose(f);
  buf[got] = '\0';
  const char* p = buf;
  const char* end = buf + got;
  int64_t k = 0;
  long dims[3];

  if (got < 2 || p[0] != '%' || p[1] != '%') {
    k = -2;
    goto done;
  }
  p = skip_ws(skip_line(p, end), end);
  while (p < end && *p == '%') p = skip_ws(skip_line(p, end), end);
  for (long& d : dims) {
    if (!take_long(p, &d)) {
      k = -2;
      goto done;
    }
  }
  while (true) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '%') {
      p = skip_line(p, end);
      continue;
    }
    if (k >= nnz_expected) {
      k = -4;
      goto done;
    }
    long i, j;
    if (!take_long(p, &i) || !take_long(p, &j)) {
      k = -3;
      goto done;
    }
    double v = 1.0;
    if (!pattern) {
      char* q;
      v = std::strtod(p, &q);
      if (q == p) {
        k = -3;
        goto done;
      }
      p = q;
    }
    rows[k] = i - 1;
    cols[k] = j - 1;
    vals[k] = v;
    ++k;
  }
done:
  std::free(buf);
  return k;
}
