// Host toolkit of sprsolve_tpu_torch: the graph and factorization passes
// that run once per operator, at setup, on the CPU.
//
// The port's own copy of sprsolve_tpu/native/hostkit.cpp (lines 27-357):
// ILU(0)/IC(0), first-fit coloring, pattern symmetrization, reverse
// Cuthill-McKee, the COO sort permutation, the bandwidth and diagonal
// counts that decide a layout, and the Matrix Market coordinate parser.
// One change: rcm_order sorts each node's new neighbours with
// std::stable_sort, so equal degrees keep their scan order on every
// standard library (the reference's std::sort is stable only on ranges of
// 16 or fewer, where libstdc++ uses insertion sort).
//
// Plain C ABI, bound with ctypes by sprsolve_tpu_torch/native.py, which
// builds this file with g++ at first use.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <queue>
#include <vector>

namespace {

// ILU(0): incomplete LU with zero fill-in, in place on a column-sorted CSR.
// On return `values` holds L (strict lower, unit diagonal implied) and U
// (upper including the diagonal) merged in the original pattern.  Returns 0
// on success or (row + 1) of the first zero pivot / structurally missing
// diagonal.  IKJ variant: each row i eliminates against prior rows k < i
// present in its own pattern, updating only positions already in row i.
template <typename T>
int64_t ilu0_impl(int64_t n, const int64_t* indptr, const int32_t* indices,
                  T* values) {
  std::vector<int64_t> diag(n, -1);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (indices[p] == (int32_t)i) {
        diag[i] = p;
        break;
      }
  std::vector<int64_t> pos(n, -1);  // col -> position in the current row
  for (int64_t i = 0; i < n; ++i) {
    if (diag[i] < 0) return i + 1;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) pos[indices[p]] = p;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int32_t k = indices[p];
      if (k >= (int32_t)i) break;  // rows are column-sorted
      T akk = values[diag[k]];
      if (akk == T(0)) return (int64_t)k + 1;
      T aik = values[p] / akk;
      values[p] = aik;
      for (int64_t q = diag[k] + 1; q < indptr[k + 1]; ++q) {
        int64_t pj = pos[indices[q]];
        if (pj >= 0) values[pj] -= aik * values[q];
      }
    }
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) pos[indices[p]] = -1;
    if (values[diag[i]] == T(0)) return i + 1;
  }
  return 0;
}

inline float conj_of(float v) { return v; }
inline double conj_of(double v) { return v; }
inline std::complex<float> conj_of(std::complex<float> v) { return std::conj(v); }
inline std::complex<double> conj_of(std::complex<double> v) { return std::conj(v); }
inline double real_of(float v) { return v; }
inline double real_of(double v) { return v; }
inline double real_of(std::complex<float> v) { return v.real(); }
inline double real_of(std::complex<double> v) { return v.real(); }

// IC(0): incomplete Cholesky A ~= L·Lᴴ with zero fill-in.  Reads the lower
// triangle (incl. diagonal) of the CSR; writes L over those positions (upper
// positions untouched).  Returns 0 on success or (row + 1) at the first
// non-positive pivot (matrix not SPD-enough for IC0 on this pattern).
template <typename T>
int64_t ic0_impl(int64_t n, const int64_t* indptr, const int32_t* indices,
                 T* values) {
  std::vector<int64_t> diag(n, -1);
  std::vector<int64_t> pos(n, -1);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (indices[p] == (int32_t)i) {
        diag[i] = p;
        break;
      }
  for (int64_t i = 0; i < n; ++i) {
    if (diag[i] < 0) return i + 1;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      if (indices[p] > (int32_t)i) break;
      pos[indices[p]] = p;
    }
    // L_ik = (A_ik − Σ_{j<k} L_ij·conj(L_kj)) / L_kk for k < i, then the
    // pivot L_ii = sqrt(A_ii − Σ_{j<i} |L_ij|²).
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int32_t k = indices[p];
      if (k >= (int32_t)i) break;
      T s = values[p];
      for (int64_t q = indptr[k]; q < indptr[k + 1]; ++q) {
        int32_t j = indices[q];
        if (j >= k) break;
        int64_t pj = pos[j];
        if (pj >= 0) s -= values[pj] * conj_of(values[q]);
      }
      values[p] = s / values[diag[k]];
    }
    double d = real_of(values[diag[i]]);
    for (int64_t p = indptr[i]; p < diag[i]; ++p) {
      T v = values[p];
      d -= real_of(v * conj_of(v));
    }
    for (int64_t p = indptr[i]; p <= diag[i]; ++p) pos[indices[p]] = -1;
    if (!(d > 0.0)) return i + 1;
    values[diag[i]] = T(std::sqrt(d));
  }
  return 0;
}

// Matrix Market tokenizer: skip blanks, newlines and '%' comment lines,
// then read one number with std::from_chars (locale-independent, unlike
// strtod: a comma-decimal LC_NUMERIC would cut "3.14" at the dot).
inline const char* mm_skip(const char* p, const char* end) {
  for (;;) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      ++p;
    if (p < end && *p == '%') {
      while (p < end && *p != '\n') ++p;
      continue;
    }
    return p;
  }
}
template <typename T>
inline const char* mm_number(const char* p, const char* end, T* out) {
  p = mm_skip(p, end);
  if (p < end && *p == '+') ++p;  // from_chars rejects a leading '+'
  auto res = std::from_chars(p, end, *out);
  return (res.ec == std::errc() && res.ptr != p) ? res.ptr : nullptr;
}

}  // namespace

extern "C" {

int64_t ilu0_f32(int64_t n, const int64_t* indptr, const int32_t* indices,
                 void* values) {
  return ilu0_impl(n, indptr, indices, static_cast<float*>(values));
}
int64_t ilu0_f64(int64_t n, const int64_t* indptr, const int32_t* indices,
                 void* values) {
  return ilu0_impl(n, indptr, indices, static_cast<double*>(values));
}
int64_t ilu0_c64(int64_t n, const int64_t* indptr, const int32_t* indices,
                 void* values) {
  return ilu0_impl(n, indptr, indices,
                   static_cast<std::complex<float>*>(values));
}
int64_t ilu0_c128(int64_t n, const int64_t* indptr, const int32_t* indices,
                  void* values) {
  return ilu0_impl(n, indptr, indices,
                   static_cast<std::complex<double>*>(values));
}

int64_t ic0_f32(int64_t n, const int64_t* indptr, const int32_t* indices,
                void* values) {
  return ic0_impl(n, indptr, indices, static_cast<float*>(values));
}
int64_t ic0_f64(int64_t n, const int64_t* indptr, const int32_t* indices,
                void* values) {
  return ic0_impl(n, indptr, indices, static_cast<double*>(values));
}
int64_t ic0_c64(int64_t n, const int64_t* indptr, const int32_t* indices,
                void* values) {
  return ic0_impl(n, indptr, indices,
                  static_cast<std::complex<float>*>(values));
}
int64_t ic0_c128(int64_t n, const int64_t* indptr, const int32_t* indices,
                 void* values) {
  return ic0_impl(n, indptr, indices,
                  static_cast<std::complex<double>*>(values));
}

// Greedy first-fit coloring of the pattern given by a *symmetric* CSR
// adjacency (indptr/indices, diagonal entries ignored).
// colors_out: n entries. Returns the number of colors.
int32_t greedy_color(int64_t n, const int64_t* indptr, const int32_t* indices,
                     int32_t* colors_out) {
  std::fill(colors_out, colors_out + n, -1);
  std::vector<int32_t> mark;  // mark[c] == i  <=>  color c used by a neighbor of i
  int32_t n_colors = 0;
  mark.reserve(64);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int32_t j = indices[p];
      if (j == i) continue;
      int32_t cj = colors_out[j];
      if (cj >= 0) {
        if (cj >= (int32_t)mark.size()) mark.resize(cj + 1, -1);
        mark[cj] = (int32_t)i;
      }
    }
    int32_t c = 0;
    while (c < (int32_t)mark.size() && mark[c] == (int32_t)i) ++c;
    colors_out[i] = c;
    if (c + 1 > n_colors) n_colors = c + 1;
  }
  return n_colors;
}

// Symmetrize a CSR pattern: out pattern = pattern(A) ∪ pattern(Aᵀ), each
// row's columns sorted.  Two-call protocol: first call with out_indices ==
// nullptr fills out_indptr (n+1) and returns total nnz; second call fills
// out_indices.
int64_t symmetrize_pattern(int64_t n, const int64_t* indptr,
                           const int32_t* indices, int64_t* out_indptr,
                           int32_t* out_indices) {
  // transpose pattern by a counting sort over the columns
  std::vector<int64_t> tptr(n + 1, 0);
  for (int64_t p = 0; p < indptr[n]; ++p) tptr[indices[p] + 1]++;
  std::partial_sum(tptr.begin(), tptr.end(), tptr.begin());
  std::vector<int32_t> tind(indptr[n]);
  std::vector<int64_t> fill(tptr.begin(), tptr.end() - 1);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      tind[fill[indices[p]]++] = (int32_t)i;

  int64_t total = 0;
  out_indptr[0] = 0;
  std::vector<int32_t> row;
  for (int64_t i = 0; i < n; ++i) {
    row.clear();
    row.insert(row.end(), indices + indptr[i], indices + indptr[i + 1]);
    row.insert(row.end(), tind.begin() + tptr[i], tind.begin() + tptr[i + 1]);
    std::sort(row.begin(), row.end());
    row.erase(std::unique(row.begin(), row.end()), row.end());
    if (out_indices)
      std::memcpy(out_indices + total, row.data(), row.size() * sizeof(int32_t));
    total += (int64_t)row.size();
    out_indptr[i + 1] = total;
  }
  return total;
}

// Reverse Cuthill-McKee ordering of a symmetric CSR pattern.
// order_out[k] = original index of the k-th node in the new ordering.
// Each component is seeded at its first unvisited node in scan order; a
// node's unvisited neighbours enter the queue by ascending degree, equal
// degrees in the order the pattern lists them (a stable sort).
void rcm_order(int64_t n, const int64_t* indptr, const int32_t* indices,
               int32_t* order_out) {
  std::vector<int64_t> degree(n);
  for (int64_t i = 0; i < n; ++i) degree[i] = indptr[i + 1] - indptr[i];
  std::vector<uint8_t> visited(n, 0);
  std::vector<int32_t> result;
  result.reserve(n);
  std::vector<int32_t> nbrs;

  for (int64_t seed = 0; seed < n; ++seed) {
    if (visited[seed]) continue;
    std::queue<int32_t> q;
    q.push((int32_t)seed);
    visited[seed] = 1;
    while (!q.empty()) {
      int32_t u = q.front();
      q.pop();
      result.push_back(u);
      nbrs.clear();
      for (int64_t p = indptr[u]; p < indptr[u + 1]; ++p) {
        int32_t v = indices[p];
        if (!visited[v]) {
          visited[v] = 1;
          nbrs.push_back(v);
        }
      }
      std::stable_sort(nbrs.begin(), nbrs.end(), [&](int32_t a, int32_t b) {
        return degree[a] < degree[b];
      });
      for (int32_t v : nbrs) q.push(v);
    }
  }
  for (int64_t k = 0; k < n; ++k) order_out[k] = result[n - 1 - k];
}

// Lexicographic (row, col) sort permutation for COO triplets: a counting
// sort by row, then a stable sort of each row by column, so equal keys keep
// their input order.  O(nnz + n).
void coo_sort_perm(int64_t n_rows, int64_t nnz, const int32_t* rows,
                   const int32_t* cols, int64_t* perm_out) {
  std::vector<int64_t> cnt(n_rows + 1, 0);
  for (int64_t k = 0; k < nnz; ++k) cnt[rows[k] + 1]++;
  std::partial_sum(cnt.begin(), cnt.end(), cnt.begin());
  std::vector<int64_t> fill(cnt.begin(), cnt.end() - 1);
  for (int64_t k = 0; k < nnz; ++k) perm_out[fill[rows[k]]++] = k;
  for (int64_t i = 0; i < n_rows; ++i) {
    std::stable_sort(perm_out + cnt[i], perm_out + cnt[i + 1],
                     [&](int64_t a, int64_t b) { return cols[a] < cols[b]; });
  }
}

// Bandwidth (max |col - row|) of a CSR pattern.
int64_t csr_bandwidth(int64_t n, const int64_t* indptr, const int32_t* indices) {
  int64_t bw = 0;
  for (int64_t i = 0; i < n; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t d = indices[p] > i ? indices[p] - i : i - indices[p];
      if (d > bw) bw = d;
    }
  return bw;
}

// Number of distinct diagonals (col - row) of a square CSR pattern.
int64_t csr_count_diagonals(int64_t n, const int64_t* indptr,
                            const int32_t* indices) {
  std::vector<uint8_t> seen(2 * n + 1, 0);
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t d = (int64_t)indices[p] - i + n;
      if (!seen[d]) {
        seen[d] = 1;
        ++count;
      }
    }
  return count;
}

// Matrix Market coordinate-entry parser: reads nnz "row col [val [imag]]"
// records from the text after the size line, skipping blank and
// '%'-comment lines.  field: 0 = pattern, 1 = real/integer, 2 = complex.
// Rows and columns come back 0-based.  Returns the number of entries
// parsed (nnz on success), or -1 on a malformed record or an early end.
int64_t mm_parse_coord(const char* text, int64_t len, int64_t nnz,
                       int32_t field, int64_t* rows, int64_t* cols,
                       double* re, double* im) {
  const char* p = text;
  const char* end = text + len;
  for (int64_t k = 0; k < nnz; ++k) {
    long long r, c;
    if (!(p = mm_number(p, end, &r))) return -1;
    if (!(p = mm_number(p, end, &c))) return -1;
    rows[k] = (int64_t)r - 1;
    cols[k] = (int64_t)c - 1;
    if (field >= 1) {
      if (!(p = mm_number(p, end, &re[k]))) return -1;
      if (field == 2 && !(p = mm_number(p, end, &im[k]))) return -1;
    }
  }
  return nnz;
}

}  // extern "C"
