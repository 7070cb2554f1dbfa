// Native (C++) Poisson oracle for the reference operator diag(theta) @ L: the
// port's own copy of the JAX package's native/poisson_oracle.cpp, with the
// same code, built with the same flags, so that both give the same bits.
//
// An independent host implementation of the exact reference system (the
// truncated 5-point Laplacian, h = 1/(n-1) vertex grids, pointwise theta row
// scaling), used as a scipy-free float64 parity oracle for the port's
// solvers. It is not a GPU kernel.
//
// Matrix-free conjugate gradients on the SPD form: diag(theta) L u = f
// <=> (-L) u = -f/theta. OpenMP parallelism over the batch.
//
// Build: g++ at first use (superresolution_for_pdes_tpu_torch/native/__init__.py)
// ABI: plain C, consumed via ctypes.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// y = (-L) x for the truncated 5-point Laplacian (zero-Dirichlet implicit
// just outside the n x n vertex grid), scaled by 1/h^2.
void apply_negL(const double* x, double* y, int64_t n, double inv_h2) {
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < n; ++j) {
      const int64_t idx = i * n + j;
      double acc = 4.0 * x[idx];
      if (j > 0) acc -= x[idx - 1];
      if (j < n - 1) acc -= x[idx + 1];
      if (i > 0) acc -= x[idx - n];
      if (i < n - 1) acc -= x[idx + n];
      y[idx] = acc * inv_h2;
    }
  }
}

double dot(const double* a, const double* b, int64_t m) {
  double s = 0.0;
  for (int64_t i = 0; i < m; ++i) s += a[i] * b[i];
  return s;
}

// CG for (-L) u = b; returns iterations used (or -1 on non-convergence).
int64_t cg_single(const double* b, double* u, int64_t n, double tol,
                  int64_t max_iters) {
  const int64_t m = n * n;
  const double inv_h2 = static_cast<double>((n - 1)) * (n - 1);
  std::vector<double> r(b, b + m), p(b, b + m), Ap(m);
  for (int64_t i = 0; i < m; ++i) u[i] = 0.0;
  const double b_norm2 = dot(b, b, m);
  const double tol2 = tol * tol * (b_norm2 > 0 ? b_norm2 : 1.0);
  double rr = b_norm2;
  for (int64_t it = 0; it < max_iters; ++it) {
    if (rr <= tol2) return it;
    apply_negL(p.data(), Ap.data(), n, inv_h2);
    const double alpha = rr / dot(p.data(), Ap.data(), m);
    for (int64_t i = 0; i < m; ++i) {
      u[i] += alpha * p[i];
      r[i] -= alpha * Ap[i];
    }
    const double rr_new = dot(r.data(), r.data(), m);
    const double beta = rr_new / rr;
    for (int64_t i = 0; i < m; ++i) p[i] = r[i] + beta * p[i];
    rr = rr_new;
  }
  return rr <= tol2 ? max_iters : -1;
}

}  // namespace

extern "C" {

// out[b] = diag(theta[b]) @ L @ u[b]; arrays are (batch, n, n) row-major.
void poisson_apply_operator(const double* theta, const double* u, double* out,
                            int64_t batch, int64_t n) {
  const double inv_h2 = static_cast<double>((n - 1)) * (n - 1);
  const int64_t m = n * n;
#pragma omp parallel for schedule(static)
  for (int64_t s = 0; s < batch; ++s) {
    apply_negL(u + s * m, out + s * m, n, inv_h2);
    for (int64_t i = 0; i < m; ++i) {
      out[s * m + i] *= -theta[s * m + i];  // undo the (-L) sign, scale rows
    }
  }
}

// Solve diag(theta[b]) L u[b] = f[b] for each batch element.
// Returns the max iteration count across the batch, or -1 if any element
// failed to converge.
int64_t poisson_solve_cg(const double* f, const double* theta, double* u,
                         int64_t batch, int64_t n, double tol,
                         int64_t max_iters) {
  const int64_t m = n * n;
  int64_t worst = 0;
#pragma omp parallel for schedule(dynamic) reduction(max : worst)
  for (int64_t s = 0; s < batch; ++s) {
    std::vector<double> b(m);
    for (int64_t i = 0; i < m; ++i) b[i] = -f[s * m + i] / theta[s * m + i];
    const int64_t iters = cg_single(b.data(), u + s * m, n, tol, max_iters);
    worst = iters < 0 ? max_iters + 1 : (iters > worst ? iters : worst);
  }
  return worst > max_iters ? -1 : worst;
}

}  // extern "C"
