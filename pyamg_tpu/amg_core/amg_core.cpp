// Native setup-phase kernels for pyamg_tpu.
//
// Analog of the reference's amg_core C++ layer (SURVEY.md
// §2.4): the serial-semantics algorithms whose ordered-greedy behavior
// cannot be vectorized — Ruge-Stuben C/F splitting (bucket-queue
// priority), greedy aggregation passes, and sequential relaxation
// sweeps.  Written from scratch against the algorithm definitions in
// SURVEY.md; flat extern "C" ABI over raw CSR arrays, bound via ctypes
// (no pybind11 dependency in this environment).
//
// Index type is int64 throughout (matches scipy's default on this
// platform); values are double.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

// ---------------------------------------------------------------------
// Parallel SpGEMM (Gustavson two-pass, OpenMP over rows) — the host
// setup phase's hot product (SURVEY.md §3.1: Galerkin RAP + prolongation
// smoothing dominate SA setup).  Row-sorted output.  int32 and int64
// index variants (scipy uses int32 below ~2^31 nnz — converting 21M-entry
// index arrays per call costs more than the product itself).
// ---------------------------------------------------------------------

namespace {

template <typename I>
void spgemm_nnz_t(I n_row, I n_col,
                  const I* Ap, const I* Aj,
                  const I* Bp, const I* Bj, I* Cnnz) {
#pragma omp parallel
  {
    std::vector<I> mark(n_col, -1);
#pragma omp for schedule(dynamic, 1024)
    for (int64_t i = 0; i < (int64_t)n_row; ++i) {
      I count = 0;
      for (I ka = Ap[i]; ka < Ap[i + 1]; ++ka) {
        const I j = Aj[ka];
        for (I kb = Bp[j]; kb < Bp[j + 1]; ++kb) {
          const I c = Bj[kb];
          if (mark[c] != (I)i) { mark[c] = (I)i; ++count; }
        }
      }
      Cnnz[i] = count;
    }
  }
}

template <typename I>
void spgemm_fill_t(I n_row, I n_col,
                   const I* Ap, const I* Aj, const double* Ax,
                   const I* Bp, const I* Bj, const double* Bx,
                   const I* Cp, I* Cj, double* Cx) {
#pragma omp parallel
  {
    std::vector<I> mark(n_col, -1);
    std::vector<double> acc(n_col, 0.0);
#pragma omp for schedule(dynamic, 1024)
    for (int64_t i = 0; i < (int64_t)n_row; ++i) {
      I len = 0;
      I* cols = Cj + Cp[i];
      for (I ka = Ap[i]; ka < Ap[i + 1]; ++ka) {
        const I j = Aj[ka];
        const double a = Ax[ka];
        for (I kb = Bp[j]; kb < Bp[j + 1]; ++kb) {
          const I c = Bj[kb];
          if (mark[c] != (I)i) {
            mark[c] = (I)i;
            acc[c] = a * Bx[kb];
            cols[len++] = c;
          } else {
            acc[c] += a * Bx[kb];
          }
        }
      }
      std::sort(cols, cols + len);
      double* vals = Cx + Cp[i];
      for (I k = 0; k < len; ++k) vals[k] = acc[cols[k]];
    }
  }
}

// Fused prolongation-smoothing step OUT = P - w * diag(dinv) @ (A @ P):
// one pass instead of SpGEMM + row-scale + scalar-multiply + SpSub
// (reference pipeline pyamg/aggregation/smooth.py::jacobi_prolongation_
// smoother).  Pattern is the union of P's and (A@P)'s rows.
template <typename I>
void jacobi_smooth_nnz_t(I n_row, I n_col,
                         const I* Ap, const I* Aj,
                         const I* Pp, const I* Pj, I* Cnnz) {
#pragma omp parallel
  {
    std::vector<I> mark(n_col, -1);
#pragma omp for schedule(dynamic, 1024)
    for (int64_t i = 0; i < (int64_t)n_row; ++i) {
      I count = 0;
      for (I kp = Pp[i]; kp < Pp[i + 1]; ++kp) {
        const I c = Pj[kp];
        if (mark[c] != (I)i) { mark[c] = (I)i; ++count; }
      }
      for (I ka = Ap[i]; ka < Ap[i + 1]; ++ka) {
        const I j = Aj[ka];
        for (I kb = Pp[j]; kb < Pp[j + 1]; ++kb) {
          const I c = Pj[kb];
          if (mark[c] != (I)i) { mark[c] = (I)i; ++count; }
        }
      }
      Cnnz[i] = count;
    }
  }
}

template <typename I>
void jacobi_smooth_fill_t(I n_row, I n_col,
                          const I* Ap, const I* Aj, const double* Ax,
                          const I* Pp, const I* Pj, const double* Px,
                          const double* dinv, double omega,
                          const I* Cp, I* Cj, double* Cx) {
#pragma omp parallel
  {
    std::vector<I> mark(n_col, -1);
    std::vector<double> acc(n_col, 0.0);
#pragma omp for schedule(dynamic, 1024)
    for (int64_t i = 0; i < (int64_t)n_row; ++i) {
      I len = 0;
      I* cols = Cj + Cp[i];
      for (I kp = Pp[i]; kp < Pp[i + 1]; ++kp) {
        const I c = Pj[kp];
        mark[c] = (I)i;
        acc[c] = Px[kp];
        cols[len++] = c;
      }
      const double s = -omega * (dinv ? dinv[i] : 1.0);
      for (I ka = Ap[i]; ka < Ap[i + 1]; ++ka) {
        const I j = Aj[ka];
        const double a = s * Ax[ka];
        for (I kb = Pp[j]; kb < Pp[j + 1]; ++kb) {
          const I c = Pj[kb];
          if (mark[c] != (I)i) {
            mark[c] = (I)i;
            acc[c] = a * Px[kb];
            cols[len++] = c;
          } else {
            acc[c] += a * Px[kb];
          }
        }
      }
      std::sort(cols, cols + len);
      double* vals = Cx + Cp[i];
      for (I k = 0; k < len; ++k) vals[k] = acc[cols[k]];
    }
  }
}

}  // namespace

extern "C" {

void spgemm_nnz_i32(int32_t n_row, int32_t n_col, const int32_t* Ap,
                    const int32_t* Aj, const int32_t* Bp,
                    const int32_t* Bj, int32_t* Cnnz) {
  spgemm_nnz_t<int32_t>(n_row, n_col, Ap, Aj, Bp, Bj, Cnnz);
}
void spgemm_nnz_i64(int64_t n_row, int64_t n_col, const int64_t* Ap,
                    const int64_t* Aj, const int64_t* Bp,
                    const int64_t* Bj, int64_t* Cnnz) {
  spgemm_nnz_t<int64_t>(n_row, n_col, Ap, Aj, Bp, Bj, Cnnz);
}
void spgemm_fill_i32(int32_t n_row, int32_t n_col, const int32_t* Ap,
                     const int32_t* Aj, const double* Ax,
                     const int32_t* Bp, const int32_t* Bj,
                     const double* Bx, const int32_t* Cp, int32_t* Cj,
                     double* Cx) {
  spgemm_fill_t<int32_t>(n_row, n_col, Ap, Aj, Ax, Bp, Bj, Bx, Cp, Cj, Cx);
}
void spgemm_fill_i64(int64_t n_row, int64_t n_col, const int64_t* Ap,
                     const int64_t* Aj, const double* Ax,
                     const int64_t* Bp, const int64_t* Bj,
                     const double* Bx, const int64_t* Cp, int64_t* Cj,
                     double* Cx) {
  spgemm_fill_t<int64_t>(n_row, n_col, Ap, Aj, Ax, Bp, Bj, Bx, Cp, Cj, Cx);
}
void jacobi_smooth_nnz_i32(int32_t n_row, int32_t n_col, const int32_t* Ap,
                           const int32_t* Aj, const int32_t* Pp,
                           const int32_t* Pj, int32_t* Cnnz) {
  jacobi_smooth_nnz_t<int32_t>(n_row, n_col, Ap, Aj, Pp, Pj, Cnnz);
}
void jacobi_smooth_nnz_i64(int64_t n_row, int64_t n_col, const int64_t* Ap,
                           const int64_t* Aj, const int64_t* Pp,
                           const int64_t* Pj, int64_t* Cnnz) {
  jacobi_smooth_nnz_t<int64_t>(n_row, n_col, Ap, Aj, Pp, Pj, Cnnz);
}
void jacobi_smooth_fill_i32(int32_t n_row, int32_t n_col,
                            const int32_t* Ap, const int32_t* Aj,
                            const double* Ax, const int32_t* Pp,
                            const int32_t* Pj, const double* Px,
                            const double* dinv, double omega,
                            const int32_t* Cp, int32_t* Cj, double* Cx) {
  jacobi_smooth_fill_t<int32_t>(n_row, n_col, Ap, Aj, Ax, Pp, Pj, Px,
                                dinv, omega, Cp, Cj, Cx);
}
void jacobi_smooth_fill_i64(int64_t n_row, int64_t n_col,
                            const int64_t* Ap, const int64_t* Aj,
                            const double* Ax, const int64_t* Pp,
                            const int64_t* Pj, const double* Px,
                            const double* dinv, double omega,
                            const int64_t* Cp, int64_t* Cj, double* Cx) {
  jacobi_smooth_fill_t<int64_t>(n_row, n_col, Ap, Aj, Ax, Pp, Pj, Px,
                                dinv, omega, Cp, Cj, Cx);
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------
// Strength of connection (SURVEY.md §2.3/§2.4: amg_core
// symmetric_strength_of_connection semantics)
// ---------------------------------------------------------------------

// Symmetric strength |A_ij| >= theta * sqrt(|A_ii| |A_jj|), one pass
// (OpenMP over rows).  Writes |A_ij| row-scaled by the largest KEPT
// off-diagonal magnitude (theta>0) or by the largest overall magnitude
// (theta==0, where the full pattern survives) into data_out, sets
// stored diagonal entries to 1, and marks surviving entries in keep.
// Returns the number of rows with a stored diagonal entry (callers fall
// back to a sparse add when < n).  Exact parity with the vectorized
// NumPy path in pyamg_tpu/strength.py (golden-tested there).
}  // extern "C" (template below needs C++ linkage)

template <typename I>
static int64_t symmetric_strength_t(I n, const I* indptr, const I* indices,
                                    const double* data, double theta,
                                    double* data_out, int8_t* keep) {
  std::vector<double> d(n, 0.0);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < (int64_t)n; ++i)
    for (I k = indptr[i]; k < indptr[i + 1]; ++k)
      if (indices[k] == (I)i) d[i] = std::fabs(data[k]);
  int64_t n_diag = 0;
#pragma omp parallel for schedule(static) reduction(+ : n_diag)
  for (int64_t i = 0; i < (int64_t)n; ++i) {
    const I k0 = indptr[i], k1 = indptr[i + 1];
    double rowmax = 0.0;
    bool has_diag = false;
    if (theta == 0.0) {
      for (I k = k0; k < k1; ++k) {
        const double a = std::fabs(data[k]);
        keep[k] = 1;
        data_out[k] = a;
        if (a > rowmax) rowmax = a;
        if (indices[k] == (I)i) has_diag = true;
      }
    } else {
      for (I k = k0; k < k1; ++k) {
        const I j = indices[k];
        if (j == (I)i) {
          keep[k] = 1;
          data_out[k] = 0.0;
          has_diag = true;
        } else {
          const double a = std::fabs(data[k]);
          const bool kp = a >= theta * std::sqrt(d[i] * d[j]);
          keep[k] = kp ? 1 : 0;
          data_out[k] = kp ? a : 0.0;
          if (kp && a > rowmax) rowmax = a;
        }
      }
    }
    const double s = rowmax != 0.0 ? 1.0 / rowmax : 0.0;
    for (I k = k0; k < k1; ++k)
      if (keep[k]) data_out[k] = indices[k] == (I)i ? 1.0 : data_out[k] * s;
    if (has_diag) ++n_diag;
  }
  return n_diag;
}

extern "C" {

int64_t symmetric_strength(int64_t n, const int64_t* indptr,
                           const int64_t* indices, const double* data,
                           double theta, double* data_out, int8_t* keep) {
  return symmetric_strength_t<int64_t>(n, indptr, indices, data, theta,
                                       data_out, keep);
}

int64_t symmetric_strength_i32(int32_t n, const int32_t* indptr,
                               const int32_t* indices, const double* data,
                               double theta, double* data_out,
                               int8_t* keep) {
  return symmetric_strength_t<int32_t>(n, indptr, indices, data, theta,
                                       data_out, keep);
}

// ---------------------------------------------------------------------
// Aggregation (SURVEY.md §2.2: amg_core standard_aggregation /
// naive_aggregation semantics)
// ---------------------------------------------------------------------

// Standard (VMB) two-pass greedy aggregation + leftovers.
// x[i] (out): aggregate id or -1; roots (out): root node per aggregate.
// Returns number of aggregates.
int64_t standard_aggregation(int64_t n, const int64_t* indptr,
                             const int64_t* indices, int64_t* x,
                             int64_t* roots) {
  std::vector<int8_t> from_pass1(n, 0);
  int64_t n_agg = 0;
  // pass 1: node i and all strong neighbors unaggregated -> new aggregate
  for (int64_t i = 0; i < n; ++i) {
    if (x[i] != -1) continue;
    bool free_nbhd = true;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int64_t j = indices[k];
      if (j != i && x[j] != -1) { free_nbhd = false; break; }
    }
    if (!free_nbhd) continue;
    roots[n_agg] = i;
    x[i] = n_agg;
    from_pass1[i] = 1;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int64_t j = indices[k];
      if (j != i) { x[j] = n_agg; from_pass1[j] = 1; }
    }
    ++n_agg;
  }
  // pass 2: join a neighboring pass-1 aggregate (no cascading)
  for (int64_t i = 0; i < n; ++i) {
    if (x[i] != -1) continue;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int64_t j = indices[k];
      if (j != i && x[j] != -1 && from_pass1[j]) {
        x[i] = -x[j] - 2;  // mark as pass-2 (decoded below)
        break;
      }
    }
  }
  for (int64_t i = 0; i < n; ++i)
    if (x[i] < -1) x[i] = -x[i] - 2;
  // pass 3: leftovers seed new aggregates with unaggregated neighbors
  for (int64_t i = 0; i < n; ++i) {
    if (x[i] != -1) continue;
    roots[n_agg] = i;
    x[i] = n_agg;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int64_t j = indices[k];
      if (j != i && x[j] == -1) x[j] = n_agg;
    }
    ++n_agg;
  }
  return n_agg;
}

// One-pass greedy aggregation.
int64_t naive_aggregation(int64_t n, const int64_t* indptr,
                          const int64_t* indices, int64_t* x,
                          int64_t* roots) {
  int64_t n_agg = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (x[i] != -1) continue;
    roots[n_agg] = i;
    x[i] = n_agg;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int64_t j = indices[k];
      if (x[j] == -1) x[j] = n_agg;
    }
    ++n_agg;
  }
  return n_agg;
}

// One Notay pairwise-matching round (SURVEY.md §2.2 pairwise
// aggregation): visit nodes in the given order; an unmatched node pairs
// with its strongest-negative-coupling unmatched neighbor.
// Returns the number of aggregates formed.
int64_t pairwise_matching(int64_t n, const int64_t* indptr,
                          const int64_t* indices, const double* data,
                          const int64_t* order, int64_t* assignment) {
  int64_t count = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    int64_t i = order[oi];
    if (assignment[i] != -1) continue;
    int64_t best_j = -1;
    double best_v = 0.0;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int64_t j = indices[k];
      if (j == i || assignment[j] != -1) continue;
      double v = -data[k];
      if (v > best_v) {
        best_v = v;
        best_j = j;
      }
    }
    assignment[i] = count;
    if (best_j >= 0) assignment[best_j] = count;
    ++count;
  }
  return count;
}

// ---------------------------------------------------------------------
// Ruge-Stuben C/F splitting (SURVEY.md §2.4 ruge_stuben.h semantics)
// ---------------------------------------------------------------------
// S: row i = {j : i strongly depends on j}   (CSR Sp/Sj)
// T: row i = {j : j strongly depends on i}   (CSR Tp/Tj; T = S^T)
// splitting (out): F_NODE=0, C_NODE=1, U_NODE=2 on entry (all 2).
//
// Classic first pass with a bucket priority queue on lambda =
// |{undecided j depending on i}| (+1 per new F dependent), followed by
// the optional second pass enforcing the F-F common-C heuristic.

static const int64_t F_NODE = 0;
static const int64_t C_NODE = 1;
static const int64_t U_NODE = 2;

void rs_cf_splitting(int64_t n, const int64_t* Sp, const int64_t* Sj,
                     const int64_t* Tp, const int64_t* Tj,
                     int64_t second_pass, int64_t* splitting) {
  std::vector<int64_t> lambda(n, 0);
  for (int64_t i = 0; i < n; ++i) {
    int64_t cnt = 0;
    for (int64_t k = Tp[i]; k < Tp[i + 1]; ++k)
      if (Tj[k] != i) ++cnt;
    lambda[i] = cnt;
  }

  // bucket queue: nodes grouped by lambda value; lambda can grow to 2n
  int64_t max_lambda = 2 * n + 1;
  std::vector<int64_t> head(max_lambda + 1, -1);
  std::vector<int64_t> next(n, -1), prev(n, -1), cur_lambda(n);
  int64_t top = 0;

  auto bucket_insert = [&](int64_t i, int64_t lam) {
    cur_lambda[i] = lam;
    next[i] = head[lam];
    prev[i] = -1;
    if (head[lam] != -1) prev[head[lam]] = i;
    head[lam] = i;
    if (lam > top) top = lam;
  };
  auto bucket_remove = [&](int64_t i) {
    int64_t lam = cur_lambda[i];
    if (prev[i] != -1) next[prev[i]] = next[i];
    else head[lam] = next[i];
    if (next[i] != -1) prev[next[i]] = prev[i];
    next[i] = prev[i] = -1;
  };

  for (int64_t i = 0; i < n; ++i) bucket_insert(i, lambda[i]);

  int64_t remaining = n;
  while (remaining > 0) {
    while (top > 0 && head[top] == -1) --top;
    if (head[top] == -1 && top == 0) {
      // only isolated nodes left
      bool any = false;
      for (int64_t i = 0; i < n; ++i) {
        if (splitting[i] == U_NODE) {
          splitting[i] = C_NODE;  // isolated -> C (harmless)
          --remaining;
          any = true;
        }
      }
      if (!any) break;
      continue;
    }
    int64_t i = head[top];
    bucket_remove(i);
    splitting[i] = C_NODE;
    --remaining;
    // every undecided j depending on i becomes F
    for (int64_t k = Tp[i]; k < Tp[i + 1]; ++k) {
      int64_t j = Tj[k];
      if (j == i || splitting[j] != U_NODE) continue;
      splitting[j] = F_NODE;
      bucket_remove(j);
      --remaining;
      // j's undecided influences become more attractive C candidates
      for (int64_t m = Sp[j]; m < Sp[j + 1]; ++m) {
        int64_t kk = Sj[m];
        if (kk != j && splitting[kk] == U_NODE) {
          bucket_remove(kk);
          bucket_insert(kk, cur_lambda[kk] + 1);
        }
      }
    }
    // i's undecided influences lose one potential dependent
    for (int64_t k = Sp[i]; k < Sp[i + 1]; ++k) {
      int64_t j = Sj[k];
      if (j != i && splitting[j] == U_NODE && cur_lambda[j] > 0) {
        bucket_remove(j);
        bucket_insert(j, cur_lambda[j] - 1);
      }
    }
  }

  if (second_pass) {
    // enforce: every strong F-F pair shares a common strong C point
    std::vector<int64_t> marker(n, -1);
    for (int64_t i = 0; i < n; ++i) {
      if (splitting[i] != F_NODE) continue;
      for (int64_t k = Sp[i]; k < Sp[i + 1]; ++k) {
        int64_t c = Sj[k];
        if (c != i && splitting[c] == C_NODE) marker[c] = i;
      }
      for (int64_t k = Sp[i]; k < Sp[i + 1]; ++k) {
        int64_t j = Sj[k];
        if (j == i || splitting[j] != F_NODE) continue;
        bool ok = false;
        for (int64_t m = Sp[j]; m < Sp[j + 1]; ++m) {
          int64_t c = Sj[m];
          if (c != j && splitting[c] == C_NODE && marker[c] == i) {
            ok = true;
            break;
          }
        }
        if (!ok) {
          splitting[i] = C_NODE;  // promote i and move to next i
          break;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// Classical (Ruge-Stuben) interpolation, two-pass symbolic/numeric
// (SURVEY.md §2.4 rs_classical_interpolation_pass1/2 semantics)
// ---------------------------------------------------------------------
// strong: per-A-entry flag (entry in the strength pattern, off-diagonal)
// splitting: F=0/C=1; cmap: fine index -> coarse index (C points only)
//
// For F row i the interpolatory set is its strong C neighbors; strong
// F-F connections distribute through common C points (or lump to the
// diagonal when none exists and modified != 0); weak connections lump
// to the diagonal.

// pass 1: count P row lengths (C rows get 1)
void rs_classical_interpolation_pass1(
    int64_t n, const int64_t* Ap, const int64_t* Aj, const int8_t* strong,
    const int64_t* splitting, int64_t* counts) {
  std::vector<int64_t> marker(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    if (splitting[i] == 1) {  // C row: identity
      counts[i] = 1;
      continue;
    }
    int64_t cnt = 0;
    for (int64_t k = Ap[i]; k < Ap[i + 1]; ++k) {
      int64_t j = Aj[k];
      if (strong[k] && splitting[j] == 1 && marker[j] != i) {
        marker[j] = i;
        ++cnt;
      }
    }
    // distance-two C points contribute only through C_i (classical
    // interpolation distributes onto C_i), so the count above is final
    counts[i] = cnt;
  }
}

// pass 2: fill P (row pointer Pp prepared by the caller from pass 1)
void rs_classical_interpolation_pass2(
    int64_t n, const int64_t* Ap, const int64_t* Aj, const double* Ax,
    const int8_t* strong, const int64_t* splitting, const int64_t* cmap,
    int64_t modified, const int64_t* Pp, int64_t* Pj, double* Px) {
  std::vector<int64_t> marker(n, -1);   // col -> slot in current row
  std::vector<int64_t> ci_marker(n, -1);  // membership of C_i
  for (int64_t i = 0; i < n; ++i) {
    int64_t pstart = Pp[i];
    if (splitting[i] == 1) {
      Pj[pstart] = cmap[i];
      Px[pstart] = 1.0;
      continue;
    }
    int64_t nlocal = 0;
    double diag = 0.0;
    // first sweep: diagonal, weak lumping, strong C slots
    for (int64_t k = Ap[i]; k < Ap[i + 1]; ++k) {
      int64_t j = Aj[k];
      double a = Ax[k];
      if (j == i) {
        diag += a;
      } else if (strong[k] && splitting[j] == 1) {
        if (marker[j] < 0) {
          marker[j] = nlocal;
          Pj[pstart + nlocal] = j;  // fine index for now
          Px[pstart + nlocal] = 0.0;
          ++nlocal;
        }
        ci_marker[j] = i;
        Px[pstart + marker[j]] -= a;
      } else if (!strong[k]) {
        diag += a;  // weak: lump
      }
    }
    // second sweep: distribute strong F-F connections
    for (int64_t k = Ap[i]; k < Ap[i + 1]; ++k) {
      int64_t m = Aj[k];
      if (m == i || !strong[k] || splitting[m] != 0) continue;
      double a_im = Ax[k];
      // denominator: sum of m's connections into C_i
      double denom = 0.0;
      for (int64_t kk = Ap[m]; kk < Ap[m + 1]; ++kk) {
        int64_t j = Aj[kk];
        if (ci_marker[j] == i) denom += Ax[kk];
      }
      if (denom == 0.0) {
        if (modified) diag += a_im;
        continue;
      }
      double scale = a_im / denom;
      for (int64_t kk = Ap[m]; kk < Ap[m + 1]; ++kk) {
        int64_t j = Aj[kk];
        if (ci_marker[j] == i) Px[pstart + marker[j]] -= scale * Ax[kk];
      }
    }
    // finalize: divide by diagonal, map to coarse indices, reset markers
    for (int64_t s = 0; s < nlocal; ++s) {
      int64_t j = Pj[pstart + s];
      marker[j] = -1;
      Pj[pstart + s] = cmap[j];
      Px[pstart + s] = (diag != 0.0) ? Px[pstart + s] / diag : 0.0;
    }
  }
}

// ---------------------------------------------------------------------
// Distance-two ("extended+i") interpolation, two-pass (SURVEY.md §2.2)
// ---------------------------------------------------------------------
// Interpolatory set of F point i: strong C neighbors plus the C
// neighbors reached through strong F neighbors.

void rs_distance_two_interpolation_pass1(
    int64_t n, const int64_t* Ap, const int64_t* Aj, const int8_t* strong,
    const int64_t* splitting, int64_t* counts) {
  std::vector<int64_t> marker(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    if (splitting[i] == 1) {
      counts[i] = 1;
      continue;
    }
    int64_t cnt = 0;
    for (int64_t k = Ap[i]; k < Ap[i + 1]; ++k) {
      int64_t j = Aj[k];
      if (!strong[k] || j == i) continue;
      if (splitting[j] == 1) {
        if (marker[j] != i) { marker[j] = i; ++cnt; }
      } else {  // strong F neighbor: extend through its C neighbors
        for (int64_t kk = Ap[j]; kk < Ap[j + 1]; ++kk) {
          int64_t c = Aj[kk];
          if (splitting[c] == 1 && marker[c] != i) {
            marker[c] = i;
            ++cnt;
          }
        }
      }
    }
    counts[i] = cnt;
  }
}

void rs_distance_two_interpolation_pass2(
    int64_t n, const int64_t* Ap, const int64_t* Aj, const double* Ax,
    const int8_t* strong, const int64_t* splitting, const int64_t* cmap,
    int64_t modified, const int64_t* Pp, int64_t* Pj, double* Px) {
  std::vector<int64_t> marker(n, -1);    // col -> slot in current row
  std::vector<int64_t> ext_marker(n, -1);  // membership of extended C set
  for (int64_t i = 0; i < n; ++i) {
    int64_t pstart = Pp[i];
    if (splitting[i] == 1) {
      Pj[pstart] = cmap[i];
      Px[pstart] = 1.0;
      continue;
    }
    int64_t nlocal = 0;
    double diag = 0.0;
    auto add_slot = [&](int64_t c) {
      if (marker[c] < 0) {
        marker[c] = nlocal;
        Pj[pstart + nlocal] = c;
        Px[pstart + nlocal] = 0.0;
        ++nlocal;
      }
      ext_marker[c] = i;
    };
    // build extended set + direct strong-C weights + diagonal lumping
    for (int64_t k = Ap[i]; k < Ap[i + 1]; ++k) {
      int64_t j = Aj[k];
      double a = Ax[k];
      if (j == i) { diag += a; continue; }
      if (!strong[k]) { diag += a; continue; }
      if (splitting[j] == 1) {
        add_slot(j);
        Px[pstart + marker[j]] -= a;
      } else {
        for (int64_t kk = Ap[j]; kk < Ap[j + 1]; ++kk) {
          int64_t c = Aj[kk];
          if (splitting[c] == 1) add_slot(c);
        }
      }
    }
    // distribute strong F-F connections over the extended set
    for (int64_t k = Ap[i]; k < Ap[i + 1]; ++k) {
      int64_t m = Aj[k];
      if (m == i || !strong[k] || splitting[m] != 0) continue;
      double a_im = Ax[k];
      double denom = 0.0;
      for (int64_t kk = Ap[m]; kk < Ap[m + 1]; ++kk)
        if (ext_marker[Aj[kk]] == i) denom += Ax[kk];
      if (denom == 0.0) {
        if (modified) diag += a_im;
        continue;
      }
      double scale = a_im / denom;
      for (int64_t kk = Ap[m]; kk < Ap[m + 1]; ++kk) {
        int64_t c = Aj[kk];
        if (ext_marker[c] == i) Px[pstart + marker[c]] -= scale * Ax[kk];
      }
    }
    for (int64_t s = 0; s < nlocal; ++s) {
      int64_t c = Pj[pstart + s];
      marker[c] = -1;
      Pj[pstart + s] = cmap[c];
      Px[pstart + s] = (diag != 0.0) ? Px[pstart + s] / diag : 0.0;
    }
  }
}

// ---------------------------------------------------------------------
// Sequential relaxation sweeps (SURVEY.md §2.4 relaxation.h semantics)
// ---------------------------------------------------------------------

// Plain Gauss-Seidel sweep over [row_start, row_stop) with step
// row_step (+1 forward, -1 backward) — the reference's
// relaxation.h::gauss_seidel loop.
void gauss_seidel(int64_t n, const int64_t* indptr, const int64_t* indices,
                  const double* data, double* x, const double* b,
                  int64_t row_start, int64_t row_stop, int64_t row_step) {
  (void)n;
  for (int64_t i = row_start; i != row_stop; i += row_step) {
    double diag = 0.0, rsum = 0.0;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int64_t j = indices[k];
      if (j == i) diag += data[k];
      else rsum += data[k] * x[j];
    }
    if (diag != 0.0) x[i] = (b[i] - rsum) / diag;
  }
}

// Gauss-Seidel over an explicit index order.
void gauss_seidel_indexed(int64_t n_order, const int64_t* indptr,
                          const int64_t* indices, const double* data,
                          double* x, const double* b, const int64_t* order,
                          int64_t order_len) {
  (void)n_order;
  for (int64_t oi = 0; oi < order_len; ++oi) {
    int64_t i = order[oi];
    double diag = 0.0, rsum = 0.0;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int64_t j = indices[k];
      if (j == i) diag += data[k];
      else rsum += data[k] * x[j];
    }
    if (diag != 0.0) x[i] = (b[i] - rsum) / diag;
  }
}

// Gauss-Seidel on the normal equations A^H A (column action): for each
// column j (in order), apply the residual-minimizing correction along
// A's j-th column.  Caller passes A in CSC (indptr/indices/data over
// columns) plus the current residual r = b - A x (updated in place).
void gauss_seidel_nr(int64_t ncols, const int64_t* indptr,
                     const int64_t* indices, const double* data, double* x,
                     double* r, const double* col_norms, int64_t direction,
                     double omega) {
  int64_t start = direction >= 0 ? 0 : ncols - 1;
  int64_t stop = direction >= 0 ? ncols : -1;
  int64_t step = direction >= 0 ? 1 : -1;
  for (int64_t j = start; j != stop; j += step) {
    if (col_norms[j] == 0.0) continue;
    double dot = 0.0;
    for (int64_t k = indptr[j]; k < indptr[j + 1]; ++k)
      dot += data[k] * r[indices[k]];
    double delta = omega * dot / col_norms[j];
    x[j] += delta;
    for (int64_t k = indptr[j]; k < indptr[j + 1]; ++k)
      r[indices[k]] -= delta * data[k];
  }
}

// Kaczmarz (Gauss-Seidel on A A^H): sequential row projections.
void gauss_seidel_ne(int64_t n, const int64_t* indptr,
                     const int64_t* indices, const double* data, double* x,
                     const double* b, const double* row_norms,
                     int64_t direction, double omega) {
  int64_t start = direction >= 0 ? 0 : n - 1;
  int64_t stop = direction >= 0 ? n : -1;
  int64_t step = direction >= 0 ? 1 : -1;
  for (int64_t i = start; i != stop; i += step) {
    if (row_norms[i] == 0.0) continue;
    double ri = b[i];
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k)
      ri -= data[k] * x[indices[k]];
    double scale = omega * ri / row_norms[i];
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k)
      x[indices[k]] += scale * data[k];
  }
}

}  // extern "C"
