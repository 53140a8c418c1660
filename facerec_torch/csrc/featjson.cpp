// Feature-record lines of features*.jsonl, written on the host.
//
// The embeddings of a flush are one contiguous (rows, row_len) array of
// float32 or float64 values, the checkpoints side by side.  Each value
// is written as Python's json.dumps writes the float that .tolist()
// makes of it: the double's shortest round-trip digits (std::to_chars),
// laid out by float.__repr__'s rules (fixed notation for a decimal
// exponent in [-4, 16) with ".0" on integers, else d.ddde±XX with at
// least two exponent digits), and NaN, Infinity, -Infinity.
//
// Everything around the values comes from the caller as text: per row a
// head and a tail, and n_dims + 1 separators written before, between and
// after the checkpoints' value lists.  Row i's line is
//   head_i sep_0 v v ... sep_1 v v ... sep_n_dims tail_i
// with the values of one list joined by commas.  Built with the host
// C++ compiler (facerec_torch/ops/_build.py), loaded with ctypes.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// the most characters one value takes: "-2.2250738585072014e-308"
constexpr int64_t kMaxValueChars = 24;

char* put_double(char* p, double v) {
  if (std::isnan(v)) {
    std::memcpy(p, "NaN", 3);
    return p + 3;
  }
  if (std::isinf(v)) {
    if (v < 0) {
      std::memcpy(p, "-Infinity", 9);
      return p + 9;
    }
    std::memcpy(p, "Infinity", 8);
    return p + 8;
  }
  char sci[32];
  const char* end =
      std::to_chars(sci, sci + sizeof sci, v, std::chars_format::scientific)
          .ptr;
  // sci is [-]d[.ddd]e±XX[X]: split it into digits and a decimal exponent
  const char* s = sci;
  if (*s == '-') *p++ = *s++;
  char digits[20];
  int nd = 0;
  for (; *s != 'e'; ++s)
    if (*s != '.') digits[nd++] = *s;
  ++s;
  const bool neg_exp = *s++ == '-';
  int e = 0;
  for (; s < end; ++s) e = e * 10 + (*s - '0');
  if (neg_exp) e = -e;

  if (e >= -4 && e < 16) {
    if (e < 0) {  // 0.000ddd
      *p++ = '0';
      *p++ = '.';
      for (int i = 0; i < -e - 1; ++i) *p++ = '0';
      std::memcpy(p, digits, nd);
      return p + nd;
    }
    if (e + 1 < nd) {  // dd.ddd
      std::memcpy(p, digits, e + 1);
      p += e + 1;
      *p++ = '.';
      std::memcpy(p, digits + e + 1, nd - e - 1);
      return p + nd - e - 1;
    }
    std::memcpy(p, digits, nd);  // ddd00.0
    p += nd;
    for (int i = 0; i < e + 1 - nd; ++i) *p++ = '0';
    *p++ = '.';
    *p++ = '0';
    return p;
  }
  *p++ = digits[0];
  if (nd > 1) {
    *p++ = '.';
    std::memcpy(p, digits + 1, nd - 1);
    p += nd - 1;
  }
  *p++ = 'e';
  *p++ = e < 0 ? '-' : '+';
  int a = e < 0 ? -e : e;
  if (a >= 100) {
    *p++ = static_cast<char>('0' + a / 100);
    a %= 100;
  }
  *p++ = static_cast<char>('0' + a / 10);
  *p++ = static_cast<char>('0' + a % 10);
  return p;
}

struct Job {
  const void* values;
  bool f64;
  int64_t row_len;
  const int64_t* dims;
  int64_t n_dims;
  const char* seps;
  const int64_t* sep_off;
  const char* texts;
  const int64_t* text_off;

  double at(int64_t i) const {
    return f64 ? static_cast<const double*>(values)[i]
               : static_cast<double>(static_cast<const float*>(values)[i]);
  }

  char* put_text(char* p, const char* base, const int64_t* off,
                 int64_t k) const {
    const int64_t n = off[k + 1] - off[k];
    std::memcpy(p, base + off[k], n);
    return p + n;
  }

  // rows [r0, r1) from p on; returns the end
  char* rows(char* p, int64_t r0, int64_t r1) const {
    for (int64_t r = r0; r < r1; ++r) {
      p = put_text(p, texts, text_off, 2 * r);
      int64_t i = r * row_len;
      for (int64_t d = 0; d < n_dims; ++d) {
        p = put_text(p, seps, sep_off, d);
        for (int64_t j = 0; j < dims[d]; ++j, ++i) {
          if (j) *p++ = ',';
          p = put_double(p, at(i));
        }
      }
      p = put_text(p, seps, sep_off, n_dims);
      p = put_text(p, texts, text_off, 2 * r + 1);
    }
    return p;
  }

  // the most bytes row r can take
  int64_t bound(int64_t r) const {
    return text_off[2 * r + 2] - text_off[2 * r] + sep_off[n_dims + 1] +
           row_len * (kMaxValueChars + 1);
  }
};

}  // namespace

extern "C" {

// Writes the lines of `rows` rows into `out` (`cap` bytes) with up to
// `n_threads` threads, each a run of rows; returns the bytes written, or
// -1 when `cap` is under the rows' bound (nothing is then written).
// `dims` sum to `row_len`; `sep_off` has n_dims + 2 offsets into `seps`,
// `text_off` 2 * rows + 1 into `texts` (head_0, tail_0, head_1, ...).
int64_t featjson_lines(const void* values, int32_t is_f64, int64_t rows,
                       int64_t row_len, const int64_t* dims, int64_t n_dims,
                       const char* seps, const int64_t* sep_off,
                       const char* texts, const int64_t* text_off, char* out,
                       int64_t cap, int32_t n_threads) {
  const Job job{values, is_f64 != 0, row_len, dims, n_dims,
                seps,   sep_off,     texts,   text_off};
  // each thread's run of rows starts at the bound of the rows before it
  std::vector<int64_t> start(rows + 1, 0);
  for (int64_t r = 0; r < rows; ++r) start[r + 1] = start[r] + job.bound(r);
  if (start[rows] > cap) return -1;

  const int64_t t = std::max<int64_t>(1, std::min<int64_t>(n_threads, rows));
  std::vector<int64_t> first(t + 1), ends(t);
  for (int64_t k = 0; k <= t; ++k) first[k] = rows * k / t;
  auto run = [&](int64_t k) {
    ends[k] = job.rows(out + start[first[k]], first[k], first[k + 1]) - out;
  };
  std::vector<std::thread> pool;
  for (int64_t k = 1; k < t; ++k) pool.emplace_back(run, k);
  run(0);
  for (auto& th : pool) th.join();
  // close the gaps the bounds left between the runs
  int64_t n = ends[0];
  for (int64_t k = 1; k < t; ++k) {
    const int64_t from = start[first[k]], len = ends[k] - from;
    std::memmove(out + n, out + from, len);
    n += len;
  }
  return n;
}

}  // extern "C"
