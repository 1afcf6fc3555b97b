// Native CPU OCP core: soft-constrained interior-point OCP solver,
// Riccati LQR solve, and RK4/IRK unicycle integrators.
//
// Role: the native runtime tier of the framework, mirroring what the
// reference reaches through the acados C library (SQP-RTI + HPIPM + IRK,
// /root/reference/src/simulation/robot_ocp_problem.py:126-136). The
// accelerator path is JAX/XLA; this library serves as
//   (a) an independent f64 validation oracle for the JAX kernels
//       (tests/test_native.py cross-checks them), and
//   (b) a dependency-free single-scenario CPU runtime: ocp_ip_solve is the
//       full production QP — box constraints on states/controls plus the
//       L1/L2-slacked obstacle constraints (robot_ocp_problem.py:106-122)
//       — solved by the same Mehrotra predictor-corrector algorithm as
//       ops/ip_qp.py, so a host-only deployment runs the same controller.
//
// Dense, unblocked, column-agnostic (all row-major), no external BLAS: the
// stage matrices are 5x5/5x2 — loop overhead dwarfs any BLAS gain.
//
// Build: make -C native   (produces libocp_core.so, loaded via ctypes)

#include <cmath>
#include <cstring>
#include <vector>

namespace {

// Solve A x = b for SPD A (n x n, row-major) via Cholesky. Returns false if
// a pivot underflows.
bool cholesky_solve(int n, const double* A, const double* b, double* x,
                    double reg) {
  std::vector<double> L(n * n, 0.0);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = A[i * n + j];
      for (int k = 0; k < j; ++k) s -= L[i * n + k] * L[j * n + k];
      if (i == j) {
        s += reg;
        if (s <= 0.0) return false;
        L[i * n + i] = std::sqrt(s);
      } else {
        L[i * n + j] = s / L[j * n + j];
      }
    }
  }
  std::vector<double> y(n);
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i * n + k] * y[k];
    y[i] = s / L[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = y[i];
    for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * x[k];
    x[i] = s / L[i * n + i];
  }
  return true;
}

// C = A^T * B, A (k x m), B (k x n) -> C (m x n)
void at_b(int k, int m, int n, const double* A, const double* B, double* C) {
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) {
      double s = 0.0;
      for (int l = 0; l < k; ++l) s += A[l * m + i] * B[l * n + j];
      C[i * n + j] = s;
    }
}

// C = A * B, A (m x k), B (k x n)
void a_b(int m, int k, int n, const double* A, const double* B, double* C) {
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) {
      double s = 0.0;
      for (int l = 0; l < k; ++l) s += A[i * k + l] * B[l * n + j];
      C[i * n + j] = s;
    }
}

void a_x(int m, int n, const double* A, const double* x, double* y) {
  for (int i = 0; i < m; ++i) {
    double s = 0.0;
    for (int j = 0; j < n; ++j) s += A[i * n + j] * x[j];
    y[i] = s;
  }
}

}  // namespace

extern "C" {

// Backward-Riccati solve of the equality-constrained LQR:
//   min sum 1/2 x'Qx + q'x + 1/2 u'Ru + r'u + u'Sx,  x_{k+1}=Ax+Bu+d
// Layouts (row-major, stage-major):
//   Q (N+1)*nx*nx, q (N+1)*nx, R N*nu*nu, r N*nu, S N*nu*nx,
//   A N*nx*nx, B N*nx*nu, d N*nx, x0 nx
// Outputs: x (N+1)*nx, u N*nu. Returns 0 on success.
int ocp_riccati_solve(int N, int nx, int nu, const double* Q, const double* q,
                      const double* R, const double* r, const double* S,
                      const double* A, const double* B, const double* d,
                      const double* x0, double reg, double* x_out,
                      double* u_out) {
  std::vector<double> P((N + 1) * nx * nx), p((N + 1) * nx);
  std::vector<double> K(N * nu * nx), kff(N * nu);
  std::memcpy(&P[N * nx * nx], &Q[N * nx * nx], sizeof(double) * nx * nx);
  std::memcpy(&p[N * nx], &q[N * nx], sizeof(double) * nx);

  std::vector<double> PB(nx * nu), PA(nx * nx), Huu(nu * nu), Hux(nu * nx),
      tmp_u(nu), tmp_x(nx), Pd_p(nx), col(nu);

  for (int k = N - 1; k >= 0; --k) {
    const double* Pk1 = &P[(k + 1) * nx * nx];
    const double* pk1 = &p[(k + 1) * nx];
    const double* Ak = &A[k * nx * nx];
    const double* Bk = &B[k * nx * nu];
    const double* dk = &d[k * nx];

    a_b(nx, nx, nu, Pk1, Bk, PB.data());               // P B
    a_b(nx, nx, nx, Pk1, Ak, PA.data());               // P A
    at_b(nx, nu, nu, Bk, PB.data(), Huu.data());       // B'PB
    for (int i = 0; i < nu * nu; ++i) Huu[i] += R[k * nu * nu + i];
    at_b(nx, nu, nx, Bk, PA.data(), Hux.data());       // B'PA
    for (int i = 0; i < nu * nx; ++i) Hux[i] += S[k * nu * nx + i];

    // K = -Huu^{-1} Hux (column by column)
    std::vector<double> rhs(nu);
    for (int j = 0; j < nx; ++j) {
      for (int i = 0; i < nu; ++i) rhs[i] = Hux[i * nx + j];
      if (!cholesky_solve(nu, Huu.data(), rhs.data(), col.data(), reg))
        return 1;
      for (int i = 0; i < nu; ++i) K[k * nu * nx + i * nx + j] = -col[i];
    }
    // kff = -Huu^{-1} (r + B'(P d + p))
    a_x(nx, nx, Pk1, dk, Pd_p.data());
    for (int i = 0; i < nx; ++i) Pd_p[i] += pk1[i];
    at_b(nx, nu, 1, Bk, Pd_p.data(), tmp_u.data());
    for (int i = 0; i < nu; ++i) tmp_u[i] += r[k * nu + i];
    if (!cholesky_solve(nu, Huu.data(), tmp_u.data(), col.data(), reg))
      return 1;
    for (int i = 0; i < nu; ++i) kff[k * nu + i] = -col[i];

    // P_k = Q + A'PA + Hux'K ; p_k = q + A'(Pd+p) + K'(Huu kff + m)
    double* Pk = &P[k * nx * nx];
    at_b(nx, nx, nx, Ak, PA.data(), Pk);               // A'PA
    for (int i = 0; i < nx; ++i)
      for (int j = 0; j < nx; ++j) {
        double s = Q[k * nx * nx + i * nx + j];
        for (int l = 0; l < nu; ++l)
          s += Hux[l * nx + i] * K[k * nu * nx + l * nx + j];
        Pk[i * nx + j] += s;
      }
    // symmetrize
    for (int i = 0; i < nx; ++i)
      for (int j = i + 1; j < nx; ++j) {
        double m2 = 0.5 * (Pk[i * nx + j] + Pk[j * nx + i]);
        Pk[i * nx + j] = m2;
        Pk[j * nx + i] = m2;
      }
    // p_k = q + A'(Pd + p) + K' m,  m = r + B'(Pd + p)  (in tmp_u)
    double* pk = &p[k * nx];
    at_b(nx, nx, 1, Ak, Pd_p.data(), pk);
    for (int i = 0; i < nx; ++i) {
      double s = q[k * nx + i];
      for (int l = 0; l < nu; ++l)
        s += K[k * nu * nx + l * nx + i] * tmp_u[l];
      pk[i] += s;
    }
  }

  // forward rollout
  std::memcpy(x_out, x0, sizeof(double) * nx);
  for (int k = 0; k < N; ++k) {
    const double* xk = &x_out[k * nx];
    double* uk = &u_out[k * nu];
    for (int i = 0; i < nu; ++i) {
      double s = kff[k * nu + i];
      for (int j = 0; j < nx; ++j) s += K[k * nu * nx + i * nx + j] * xk[j];
      uk[i] = s;
    }
    double* xk1 = &x_out[(k + 1) * nx];
    for (int i = 0; i < nx; ++i) {
      double s = d[k * nx + i];
      for (int j = 0; j < nx; ++j) s += A[k * nx * nx + i * nx + j] * xk[j];
      for (int j = 0; j < nu; ++j) s += B[k * nx * nu + i * nu + j] * uk[j];
      xk1[i] = s;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Soft-constrained interior-point OCP solve (the full production QP).
//
// Same problem and algorithm as ops/ip_qp.solve_ocp_qp (Mehrotra
// predictor-corrector with HPIPM-style stage-wise elimination of the
// slacked obstacle constraints), f64, single scenario, early exit on
// convergence. Layouts row-major, stage-major:
//   A N*nx*nx, B N*nx*nu, c N*nx, dx0 nx,
//   Q (N+1)*nx*nx, q (N+1)*nx, R N*nu*nu, r N*nu, S N*nu*nx,
//   lb_u/ub_u N*nu, lb_x/ub_x (N+1)*nbx (selection rows idxbx),
//   C (N+1)*M*nx, hval (N+1)*M, zl/Zl (N+1)*M.
// Outputs: dx (N+1)*nx, du N*nu, s (N+1)*M, plus the final duality measure
// and stationarity residual. Returns the iteration count used, or -1 on a
// non-finite direction (iterate kept at its last finite state).
int ocp_ip_solve(int N, int nx, int nu, int M, int nbx, const int* idxbx,
                 const double* A, const double* B, const double* c,
                 const double* dx0,
                 const double* Q, const double* q, const double* R,
                 const double* r, const double* S,
                 const double* lb_u, const double* ub_u,
                 const double* lb_x, const double* ub_x,
                 const double* C, const double* hval,
                 const double* zl, const double* Zl_in,
                 int iters, double tau, double reg, double tol,
                 double stat_tol, double sigma_max,
                 double* dx_out, double* du_out, double* s_out,
                 double* mu_out, double* stat_out) {
  const double T_FLOOR = 1e-12, ZL_FLOOR = 1e-6, TINY = 1e-30;
  const double t_min = 0.1, mu0 = 1.0;
  const int st = N + 1;
  const double n_pairs = 2.0 * N * nu + 2.0 * st * nbx + 2.0 * st * M;

  std::vector<double> dx(st * nx), du(N * nu, 0.0), s(st * M),
      nu_d(N * nx, 0.0);
  std::vector<double> t_ul(N * nu), l_ul(N * nu), t_uu(N * nu), l_uu(N * nu),
      t_xl(st * nbx), l_xl(st * nbx), t_xu(st * nbx), l_xu(st * nbx),
      t_h(st * M), l_h(st * M), l_s(st * M);
  std::vector<double> Zl(st * M);
  for (int i = 0; i < st * M; ++i) Zl[i] = std::max(Zl_in[i], ZL_FLOOR);

  // ---- initialization (matches solve_ocp_qp) -----------------------------
  std::memcpy(dx.data(), dx0, sizeof(double) * nx);
  for (int k = 0; k < N; ++k) {
    for (int i = 0; i < nx; ++i) {
      double v = c[k * nx + i];
      for (int j = 0; j < nx; ++j)
        v += A[k * nx * nx + i * nx + j] * dx[k * nx + j];
      dx[(k + 1) * nx + i] = v;
    }
  }
  for (int k = 0; k < st; ++k) {
    for (int m = 0; m < M; ++m) {
      double g = hval[k * M + m];
      for (int j = 0; j < nx; ++j)
        g += C[(k * M + m) * nx + j] * dx[k * nx + j];
      double s0 = std::max(t_min, t_min - g);
      s[k * M + m] = s0;
      double th = std::max(g + s0, t_min);
      t_h[k * M + m] = th;
      l_h[k * M + m] = mu0 / th;
      l_s[k * M + m] = mu0 / s0;
    }
    for (int i = 0; i < nbx; ++i) {
      double xv = dx[k * nx + idxbx[i]];
      double t = std::max(xv - lb_x[k * nbx + i], t_min);
      t_xl[k * nbx + i] = t;
      l_xl[k * nbx + i] = mu0 / t;
      t = std::max(ub_x[k * nbx + i] - xv, t_min);
      t_xu[k * nbx + i] = t;
      l_xu[k * nbx + i] = mu0 / t;
    }
  }
  for (int k = 0; k < N; ++k)
    for (int i = 0; i < nu; ++i) {
      double t = std::max(-lb_u[k * nu + i], t_min);
      t_ul[k * nu + i] = t;
      l_ul[k * nu + i] = mu0 / t;
      t = std::max(ub_u[k * nu + i], t_min);
      t_uu[k * nu + i] = t;
      l_uu[k * nu + i] = mu0 / t;
    }

  // work arrays
  std::vector<double> r_ul(N * nu), r_uu(N * nu), r_xl(st * nbx),
      r_xu(st * nbx), r_h(st * M), r_s(st * M), r_dyn(N * nx),
      r_x(st * nx), r_u(N * nu);
  std::vector<double> s_ul(N * nu), s_uu(N * nu), s_xl(st * nbx),
      s_xu(st * nbx), s_h(st * M), s_s(st * M), zeta(st * M),
      s_eff(st * M);
  std::vector<double> Qbar(st * nx * nx), Rbar(N * nu * nu);
  std::vector<double> P(st * nx * nx), K(N * nu * nx),
      Hchol(N * nu * nu);
  std::vector<double> qbar(st * nx), rbar(N * nu), d_rhs(N * nx);
  std::vector<double> Ddx(st * nx), Ddu(N * nu), Dnu(N * nx);
  // pair deltas (affine pass also stores the dt*dl products for corrector)
  std::vector<double> A_ul(N * nu), A_uu(N * nu), A_xl(st * nbx),
      A_xu(st * nbx), A_h(st * M), A_s2(st * M);  // dt_aff*dl_aff products
  std::vector<double> Dt_ul(N * nu), Dl_ul(N * nu), Dt_uu(N * nu),
      Dl_uu(N * nu), Dt_xl(st * nbx), Dl_xl(st * nbx), Dt_xu(st * nbx),
      Dl_xu(st * nbx), Dt_h(st * M), Dl_h(st * M), Dl_s(st * M),
      Ds(st * M);

  double mu = 0.0, stat = 0.0;
  int used = 0;

  auto sig = [&](double l, double t) {
    double v = l / std::max(t, T_FLOOR);
    return std::min(std::max(v, 0.0), sigma_max);
  };

  // factorize P/K/chol(Huu) for the current Qbar/Rbar
  auto factorize = [&]() -> bool {
    std::memcpy(&P[N * nx * nx], &Qbar[N * nx * nx],
                sizeof(double) * nx * nx);
    std::vector<double> PB(nx * nu), PA(nx * nx), Huu(nu * nu),
        Hux(nu * nx), col(nu), rhs(nu);
    for (int k = N - 1; k >= 0; --k) {
      const double* Pk1 = &P[(k + 1) * nx * nx];
      const double* Ak = &A[k * nx * nx];
      const double* Bk = &B[k * nx * nu];
      a_b(nx, nx, nu, Pk1, Bk, PB.data());
      a_b(nx, nx, nx, Pk1, Ak, PA.data());
      at_b(nx, nu, nu, Bk, PB.data(), Huu.data());
      for (int i = 0; i < nu * nu; ++i) Huu[i] += Rbar[k * nu * nu + i];
      at_b(nx, nu, nx, Bk, PA.data(), Hux.data());
      for (int i = 0; i < nu * nx; ++i) Hux[i] += S[k * nu * nx + i];
      // Cholesky of Huu + reg
      double* L = &Hchol[k * nu * nu];
      for (int i = 0; i < nu * nu; ++i) L[i] = 0.0;
      for (int i = 0; i < nu; ++i)
        for (int j = 0; j <= i; ++j) {
          double acc = Huu[i * nu + j];
          for (int l2 = 0; l2 < j; ++l2)
            acc -= L[i * nu + l2] * L[j * nu + l2];
          if (i == j) {
            acc += reg;
            if (acc <= 0.0) return false;
            L[i * nu + i] = std::sqrt(acc);
          } else {
            L[i * nu + j] = acc / L[j * nu + j];
          }
        }
      auto chol_solve_u = [&](const double* b2, double* x2) {
        std::vector<double> y(nu);
        for (int i = 0; i < nu; ++i) {
          double acc = b2[i];
          for (int l2 = 0; l2 < i; ++l2) acc -= L[i * nu + l2] * y[l2];
          y[i] = acc / L[i * nu + i];
        }
        for (int i = nu - 1; i >= 0; --i) {
          double acc = y[i];
          for (int l2 = i + 1; l2 < nu; ++l2)
            acc -= L[l2 * nu + i] * x2[l2];
          x2[i] = acc / L[i * nu + i];
        }
      };
      for (int j = 0; j < nx; ++j) {
        for (int i = 0; i < nu; ++i) rhs[i] = Hux[i * nx + j];
        chol_solve_u(rhs.data(), col.data());
        for (int i = 0; i < nu; ++i) K[k * nu * nx + i * nx + j] = -col[i];
      }
      double* Pk = &P[k * nx * nx];
      at_b(nx, nx, nx, Ak, PA.data(), Pk);
      for (int i = 0; i < nx; ++i)
        for (int j = 0; j < nx; ++j) {
          double acc = Qbar[k * nx * nx + i * nx + j];
          for (int l2 = 0; l2 < nu; ++l2)
            acc += Hux[l2 * nx + i] * K[k * nu * nx + l2 * nx + j];
          Pk[i * nx + j] += acc;
        }
      for (int i = 0; i < nx; ++i)
        for (int j = i + 1; j < nx; ++j) {
          double m2 = 0.5 * (Pk[i * nx + j] + Pk[j * nx + i]);
          Pk[i * nx + j] = m2;
          Pk[j * nx + i] = m2;
        }
    }
    return true;
  };

  // back-substitute one RHS: qbar/rbar/d_rhs -> Ddx (x0 = 0), Ddu, Dnu
  auto kkt_solve = [&]() {
    std::vector<double> p(st * nx), kff(N * nu), Pd_p(nx), m(nu), col(nu);
    std::memcpy(&p[N * nx], &qbar[N * nx], sizeof(double) * nx);
    for (int k = N - 1; k >= 0; --k) {
      const double* Pk1 = &P[(k + 1) * nx * nx];
      a_x(nx, nx, Pk1, &d_rhs[k * nx], Pd_p.data());
      for (int i = 0; i < nx; ++i) Pd_p[i] += p[(k + 1) * nx + i];
      at_b(nx, nu, 1, &B[k * nx * nu], Pd_p.data(), m.data());
      for (int i = 0; i < nu; ++i) m[i] += rbar[k * nu + i];
      const double* L = &Hchol[k * nu * nu];
      std::vector<double> y(nu);
      for (int i = 0; i < nu; ++i) {
        double acc = m[i];
        for (int l2 = 0; l2 < i; ++l2) acc -= L[i * nu + l2] * y[l2];
        y[i] = acc / L[i * nu + i];
      }
      for (int i = nu - 1; i >= 0; --i) {
        double acc = y[i];
        for (int l2 = i + 1; l2 < nu; ++l2) acc -= L[l2 * nu + i] * col[l2];
        col[i] = acc / L[i * nu + i];
      }
      for (int i = 0; i < nu; ++i) kff[k * nu + i] = -col[i];
      double* pk = &p[k * nx];
      at_b(nx, nx, 1, &A[k * nx * nx], Pd_p.data(), pk);
      for (int i = 0; i < nx; ++i) {
        double acc = qbar[k * nx + i];
        for (int l2 = 0; l2 < nu; ++l2)
          acc += K[k * nu * nx + l2 * nx + i] * m[l2];
        pk[i] += acc;
      }
    }
    for (int i = 0; i < nx; ++i) Ddx[i] = 0.0;
    for (int k = 0; k < N; ++k) {
      for (int i = 0; i < nu; ++i) {
        double acc = kff[k * nu + i];
        for (int j = 0; j < nx; ++j)
          acc += K[k * nu * nx + i * nx + j] * Ddx[k * nx + j];
        Ddu[k * nu + i] = acc;
      }
      for (int i = 0; i < nx; ++i) {
        double acc = d_rhs[k * nx + i];
        for (int j = 0; j < nx; ++j)
          acc += A[k * nx * nx + i * nx + j] * Ddx[k * nx + j];
        for (int j = 0; j < nu; ++j)
          acc += B[k * nx * nu + i * nu + j] * Ddu[k * nu + j];
        Ddx[(k + 1) * nx + i] = acc;
      }
      // nu_k = -(P_{k+1} x_{k+1} + p_{k+1})
      for (int i = 0; i < nx; ++i) {
        double acc = p[(k + 1) * nx + i];
        for (int j = 0; j < nx; ++j)
          acc += P[(k + 1) * nx * nx + i * nx + j] * Ddx[(k + 1) * nx + j];
        Dnu[k * nx + i] = -acc;
      }
    }
  };

  // one full direction from betas -> all pair deltas (in the D* arrays)
  auto directions = [&](const std::vector<double>& b_ul,
                        const std::vector<double>& b_uu,
                        const std::vector<double>& b_xl,
                        const std::vector<double>& b_xu,
                        const std::vector<double>& b_h,
                        const std::vector<double>& b_s) {
    for (int k = 0; k < st; ++k) {
      std::vector<double> bh_hat(M);
      for (int m2 = 0; m2 < M; ++m2) {
        int id = k * M + m2;
        double rho = -r_s[id] + b_h[id] + b_s[id] - s_h[id] * r_h[id];
        bh_hat[m2] = b_h[id] - s_h[id] * r_h[id] - s_h[id] * rho / zeta[id];
      }
      for (int i = 0; i < nx; ++i) {
        double acc = r_x[k * nx + i];
        for (int m2 = 0; m2 < M; ++m2)
          acc -= C[(k * M + m2) * nx + i] * bh_hat[m2];
        qbar[k * nx + i] = acc;
      }
      for (int i = 0; i < nbx; ++i) {
        int id = k * nbx + i;
        qbar[k * nx + idxbx[i]] +=
            -(b_xl[id] - s_xl[id] * r_xl[id])
            + (b_xu[id] - s_xu[id] * r_xu[id]);
      }
    }
    for (int k = 0; k < N; ++k)
      for (int i = 0; i < nu; ++i) {
        int id = k * nu + i;
        rbar[id] = r_u[id] - (b_ul[id] - s_ul[id] * r_ul[id])
                   + (b_uu[id] - s_uu[id] * r_uu[id]);
      }
    for (int i = 0; i < N * nx; ++i) d_rhs[i] = -r_dyn[i];
    kkt_solve();
    for (int k = 0; k < st; ++k) {
      for (int m2 = 0; m2 < M; ++m2) {
        int id = k * M + m2;
        double CD = 0.0;
        for (int j = 0; j < nx; ++j)
          CD += C[(k * M + m2) * nx + j] * Ddx[k * nx + j];
        double rho = -r_s[id] + b_h[id] + b_s[id] - s_h[id] * r_h[id];
        double ds = (rho - s_h[id] * CD) / zeta[id];
        double dth = CD + ds + r_h[id];
        Ds[id] = ds;
        Dt_h[id] = dth;
        Dl_h[id] = b_h[id] - s_h[id] * dth;
        Dl_s[id] = b_s[id] - s_s[id] * ds;
      }
      for (int i = 0; i < nbx; ++i) {
        int id = k * nbx + i;
        double dxv = Ddx[k * nx + idxbx[i]];
        Dt_xl[id] = dxv + r_xl[id];
        Dt_xu[id] = -dxv + r_xu[id];
        Dl_xl[id] = b_xl[id] - s_xl[id] * Dt_xl[id];
        Dl_xu[id] = b_xu[id] - s_xu[id] * Dt_xu[id];
      }
    }
    for (int k = 0; k < N; ++k)
      for (int i = 0; i < nu; ++i) {
        int id = k * nu + i;
        Dt_ul[id] = Ddu[id] + r_ul[id];
        Dt_uu[id] = -Ddu[id] + r_uu[id];
        Dl_ul[id] = b_ul[id] - s_ul[id] * Dt_ul[id];
        Dl_uu[id] = b_uu[id] - s_uu[id] * Dt_uu[id];
      }
  };

  auto max_step = [&](const double* v, const double* dv, int n,
                      double lim) {
    double a = lim;
    for (int i = 0; i < n; ++i)
      if (dv[i] < 0.0) a = std::min(a, -v[i] / dv[i]);
    return a;
  };

  for (int it = 0; it < iters; ++it) {
    used = it + 1;
    // ---- residuals -------------------------------------------------------
    mu = 0.0;
    for (int k = 0; k < N; ++k)
      for (int i = 0; i < nu; ++i) {
        int id = k * nu + i;
        r_ul[id] = (du[id] - lb_u[id]) - t_ul[id];
        r_uu[id] = (ub_u[id] - du[id]) - t_uu[id];
        mu += t_ul[id] * l_ul[id] + t_uu[id] * l_uu[id];
      }
    for (int k = 0; k < st; ++k) {
      for (int i = 0; i < nbx; ++i) {
        int id = k * nbx + i;
        double xv = dx[k * nx + idxbx[i]];
        r_xl[id] = (xv - lb_x[id]) - t_xl[id];
        r_xu[id] = (ub_x[id] - xv) - t_xu[id];
        mu += t_xl[id] * l_xl[id] + t_xu[id] * l_xu[id];
      }
      for (int m2 = 0; m2 < M; ++m2) {
        int id = k * M + m2;
        double g = hval[id];
        for (int j = 0; j < nx; ++j)
          g += C[id * nx + j] * dx[k * nx + j];
        r_h[id] = (g + s[id]) - t_h[id];
        r_s[id] = Zl[id] * s[id] + zl[id] - l_h[id] - l_s[id];
        mu += t_h[id] * l_h[id] + s[id] * l_s[id];
      }
    }
    mu /= n_pairs;
    for (int k = 0; k < N; ++k)
      for (int i = 0; i < nx; ++i) {
        double acc = dx[(k + 1) * nx + i] - c[k * nx + i];
        for (int j = 0; j < nx; ++j)
          acc -= A[k * nx * nx + i * nx + j] * dx[k * nx + j];
        for (int j = 0; j < nu; ++j)
          acc -= B[k * nx * nu + i * nu + j] * du[k * nu + j];
        r_dyn[k * nx + i] = acc;
      }
    stat = 0.0;
    for (int k = 0; k < st; ++k)
      for (int i = 0; i < nx; ++i) {
        double acc = q[k * nx + i];
        for (int j = 0; j < nx; ++j)
          acc += Q[k * nx * nx + i * nx + j] * dx[k * nx + j];
        if (k < N) {
          for (int l2 = 0; l2 < nu; ++l2)
            acc += S[k * nu * nx + l2 * nx + i] * du[k * nu + l2];
          for (int j = 0; j < nx; ++j)
            acc -= A[k * nx * nx + j * nx + i] * nu_d[k * nx + j];
        }
        if (k > 0) acc += nu_d[(k - 1) * nx + i];
        for (int i2 = 0; i2 < nbx; ++i2)
          if (idxbx[i2] == i)
            acc -= l_xl[k * nbx + i2] - l_xu[k * nbx + i2];
        for (int m2 = 0; m2 < M; ++m2)
          acc -= C[(k * M + m2) * nx + i] * l_h[k * M + m2];
        r_x[k * nx + i] = acc;
        if (k > 0) stat = std::max(stat, std::fabs(acc));
      }
    for (int k = 0; k < N; ++k)
      for (int i = 0; i < nu; ++i) {
        double acc = r[k * nu + i];
        for (int j = 0; j < nu; ++j)
          acc += R[k * nu * nu + i * nu + j] * du[k * nu + j];
        for (int j = 0; j < nx; ++j)
          acc += S[k * nu * nx + i * nx + j] * dx[k * nx + j];
        for (int j = 0; j < nx; ++j)
          acc -= B[k * nx * nu + j * nu + i] * nu_d[k * nx + j];
        acc -= l_ul[k * nu + i] - l_uu[k * nu + i];
        r_u[k * nu + i] = acc;
        stat = std::max(stat, std::fabs(acc));
      }
    if (mu < tol && stat < stat_tol) break;

    // ---- sigmas + condensed Hessians ------------------------------------
    for (int i = 0; i < N * nu; ++i) {
      s_ul[i] = sig(l_ul[i], t_ul[i]);
      s_uu[i] = sig(l_uu[i], t_uu[i]);
    }
    for (int i = 0; i < st * nbx; ++i) {
      s_xl[i] = sig(l_xl[i], t_xl[i]);
      s_xu[i] = sig(l_xu[i], t_xu[i]);
    }
    for (int i = 0; i < st * M; ++i) {
      s_h[i] = sig(l_h[i], t_h[i]);
      s_s[i] = sig(l_s[i], s[i]);
      zeta[i] = Zl[i] + s_h[i] + s_s[i];
      s_eff[i] = s_h[i] * (Zl[i] + s_s[i]) / zeta[i];
    }
    for (int k = 0; k < st; ++k) {
      double* Qb = &Qbar[k * nx * nx];
      std::memcpy(Qb, &Q[k * nx * nx], sizeof(double) * nx * nx);
      for (int i = 0; i < nbx; ++i)
        Qb[idxbx[i] * nx + idxbx[i]] +=
            s_xl[k * nbx + i] + s_xu[k * nbx + i];
      for (int i = 0; i < nx; ++i)
        for (int j = 0; j < nx; ++j) {
          double acc = 0.0;
          for (int m2 = 0; m2 < M; ++m2)
            acc += C[(k * M + m2) * nx + i] * s_eff[k * M + m2]
                   * C[(k * M + m2) * nx + j];
          Qb[i * nx + j] += acc;
        }
    }
    for (int k = 0; k < N; ++k) {
      double* Rb = &Rbar[k * nu * nu];
      std::memcpy(Rb, &R[k * nu * nu], sizeof(double) * nu * nu);
      for (int i = 0; i < nu; ++i)
        Rb[i * nu + i] += s_ul[k * nu + i] + s_uu[k * nu + i];
    }
    if (!factorize()) return -1;

    // ---- predictor (affine scaling) -------------------------------------
    std::vector<double> b_ul(N * nu), b_uu(N * nu), b_xl(st * nbx),
        b_xu(st * nbx), b_h(st * M), b_s(st * M);
    for (int i = 0; i < N * nu; ++i) {
      b_ul[i] = -l_ul[i];
      b_uu[i] = -l_uu[i];
    }
    for (int i = 0; i < st * nbx; ++i) {
      b_xl[i] = -l_xl[i];
      b_xu[i] = -l_xu[i];
    }
    for (int i = 0; i < st * M; ++i) {
      b_h[i] = -l_h[i];
      b_s[i] = -l_s[i];
    }
    directions(b_ul, b_uu, b_xl, b_xu, b_h, b_s);
    double ap = 1.0, ad = 1.0;
    ap = std::min(ap, max_step(t_ul.data(), Dt_ul.data(), N * nu, 1.0));
    ap = std::min(ap, max_step(t_uu.data(), Dt_uu.data(), N * nu, 1.0));
    ap = std::min(ap, max_step(t_xl.data(), Dt_xl.data(), st * nbx, 1.0));
    ap = std::min(ap, max_step(t_xu.data(), Dt_xu.data(), st * nbx, 1.0));
    ap = std::min(ap, max_step(t_h.data(), Dt_h.data(), st * M, 1.0));
    ap = std::min(ap, max_step(s.data(), Ds.data(), st * M, 1.0));
    ad = std::min(ad, max_step(l_ul.data(), Dl_ul.data(), N * nu, 1.0));
    ad = std::min(ad, max_step(l_uu.data(), Dl_uu.data(), N * nu, 1.0));
    ad = std::min(ad, max_step(l_xl.data(), Dl_xl.data(), st * nbx, 1.0));
    ad = std::min(ad, max_step(l_xu.data(), Dl_xu.data(), st * nbx, 1.0));
    ad = std::min(ad, max_step(l_h.data(), Dl_h.data(), st * M, 1.0));
    ad = std::min(ad, max_step(l_s.data(), Dl_s.data(), st * M, 1.0));
    double mu_aff = 0.0;
    auto compl_after = [&](const double* t, const double* dt,
                           const double* l, const double* dl, int n) {
      for (int i = 0; i < n; ++i)
        mu_aff += (t[i] + ap * dt[i]) * (l[i] + ad * dl[i]);
    };
    compl_after(t_ul.data(), Dt_ul.data(), l_ul.data(), Dl_ul.data(), N * nu);
    compl_after(t_uu.data(), Dt_uu.data(), l_uu.data(), Dl_uu.data(), N * nu);
    compl_after(t_xl.data(), Dt_xl.data(), l_xl.data(), Dl_xl.data(),
                st * nbx);
    compl_after(t_xu.data(), Dt_xu.data(), l_xu.data(), Dl_xu.data(),
                st * nbx);
    compl_after(t_h.data(), Dt_h.data(), l_h.data(), Dl_h.data(), st * M);
    compl_after(s.data(), Ds.data(), l_s.data(), Dl_s.data(), st * M);
    mu_aff /= n_pairs;
    double sg = mu_aff / std::max(mu, T_FLOOR);
    double sig_c = std::min(std::max(sg * sg * sg, 0.0), 1.0);
    double mu_t = sig_c * mu;

    // affine products for the corrector betas
    for (int i = 0; i < N * nu; ++i) {
      A_ul[i] = Dt_ul[i] * Dl_ul[i];
      A_uu[i] = Dt_uu[i] * Dl_uu[i];
    }
    for (int i = 0; i < st * nbx; ++i) {
      A_xl[i] = Dt_xl[i] * Dl_xl[i];
      A_xu[i] = Dt_xu[i] * Dl_xu[i];
    }
    for (int i = 0; i < st * M; ++i) {
      A_h[i] = Dt_h[i] * Dl_h[i];
      A_s2[i] = Ds[i] * Dl_s[i];
    }

    // ---- corrector -------------------------------------------------------
    auto beta_c = [&](double t, double l, double prod) {
      return (mu_t - t * l - prod) / std::max(t, T_FLOOR);
    };
    for (int i = 0; i < N * nu; ++i) {
      b_ul[i] = beta_c(t_ul[i], l_ul[i], A_ul[i]);
      b_uu[i] = beta_c(t_uu[i], l_uu[i], A_uu[i]);
    }
    for (int i = 0; i < st * nbx; ++i) {
      b_xl[i] = beta_c(t_xl[i], l_xl[i], A_xl[i]);
      b_xu[i] = beta_c(t_xu[i], l_xu[i], A_xu[i]);
    }
    for (int i = 0; i < st * M; ++i) {
      b_h[i] = beta_c(t_h[i], l_h[i], A_h[i]);
      b_s[i] = beta_c(s[i], l_s[i], A_s2[i]);
    }
    directions(b_ul, b_uu, b_xl, b_xu, b_h, b_s);
    double a_p = std::min(1.0, tau * max_step(t_ul.data(), Dt_ul.data(),
                                              N * nu, 2.0));
    a_p = std::min(a_p, tau * max_step(t_uu.data(), Dt_uu.data(), N * nu,
                                       2.0));
    a_p = std::min(a_p, tau * max_step(t_xl.data(), Dt_xl.data(), st * nbx,
                                       2.0));
    a_p = std::min(a_p, tau * max_step(t_xu.data(), Dt_xu.data(), st * nbx,
                                       2.0));
    a_p = std::min(a_p, tau * max_step(t_h.data(), Dt_h.data(), st * M,
                                       2.0));
    a_p = std::min(a_p, tau * max_step(s.data(), Ds.data(), st * M, 2.0));
    a_p = std::min(a_p, 1.0);
    double a_d = std::min(1.0, tau * max_step(l_ul.data(), Dl_ul.data(),
                                              N * nu, 2.0));
    a_d = std::min(a_d, tau * max_step(l_uu.data(), Dl_uu.data(), N * nu,
                                       2.0));
    a_d = std::min(a_d, tau * max_step(l_xl.data(), Dl_xl.data(), st * nbx,
                                       2.0));
    a_d = std::min(a_d, tau * max_step(l_xu.data(), Dl_xu.data(), st * nbx,
                                       2.0));
    a_d = std::min(a_d, tau * max_step(l_h.data(), Dl_h.data(), st * M,
                                       2.0));
    a_d = std::min(a_d, tau * max_step(l_s.data(), Dl_s.data(), st * M,
                                       2.0));
    a_d = std::min(a_d, 1.0);

    // non-finite guard: keep the last finite iterate and bail
    bool finite = std::isfinite(a_p) && std::isfinite(a_d);
    for (int i = 0; finite && i < st * nx; ++i)
      finite = std::isfinite(Ddx[i]);
    for (int i = 0; finite && i < N * nu; ++i)
      finite = std::isfinite(Ddu[i]);
    if (!finite) {
      used = -1;
      break;
    }

    // ---- update ----------------------------------------------------------
    auto upd_pos = [&](double* v, const double* dv, int n, double a) {
      for (int i = 0; i < n; ++i) v[i] = std::max(v[i] + a * dv[i], TINY);
    };
    for (int i = 0; i < st * nx; ++i) dx[i] += a_p * Ddx[i];
    for (int i = 0; i < N * nu; ++i) du[i] += a_p * Ddu[i];
    for (int i = 0; i < N * nx; ++i) nu_d[i] += a_d * Dnu[i];
    upd_pos(s.data(), Ds.data(), st * M, a_p);
    upd_pos(t_ul.data(), Dt_ul.data(), N * nu, a_p);
    upd_pos(t_uu.data(), Dt_uu.data(), N * nu, a_p);
    upd_pos(t_xl.data(), Dt_xl.data(), st * nbx, a_p);
    upd_pos(t_xu.data(), Dt_xu.data(), st * nbx, a_p);
    upd_pos(t_h.data(), Dt_h.data(), st * M, a_p);
    upd_pos(l_ul.data(), Dl_ul.data(), N * nu, a_d);
    upd_pos(l_uu.data(), Dl_uu.data(), N * nu, a_d);
    upd_pos(l_xl.data(), Dl_xl.data(), st * nbx, a_d);
    upd_pos(l_xu.data(), Dl_xu.data(), st * nbx, a_d);
    upd_pos(l_h.data(), Dl_h.data(), st * M, a_d);
    upd_pos(l_s.data(), Dl_s.data(), st * M, a_d);
  }

  std::memcpy(dx_out, dx.data(), sizeof(double) * st * nx);
  std::memcpy(du_out, du.data(), sizeof(double) * N * nu);
  std::memcpy(s_out, s.data(), sizeof(double) * st * M);
  *mu_out = mu;
  *stat_out = stat;
  return used;
}

// Unicycle dynamics f(s, u) (robot_model.py:39-43)
static void unicycle_f(const double* s, const double* u, double* out) {
  out[0] = s[3] * std::cos(s[2]);
  out[1] = s[3] * std::sin(s[2]);
  out[2] = s[4];
  out[3] = u[0];
  out[4] = u[1];
}

// RK4 step for the unicycle (nx=5, nu=2)
void unicycle_rk4(const double* x, const double* u, double dt, double* out) {
  double k1[5], k2[5], k3[5], k4[5], t[5];
  unicycle_f(x, u, k1);
  for (int i = 0; i < 5; ++i) t[i] = x[i] + 0.5 * dt * k1[i];
  unicycle_f(t, u, k2);
  for (int i = 0; i < 5; ++i) t[i] = x[i] + 0.5 * dt * k2[i];
  unicycle_f(t, u, k3);
  for (int i = 0; i < 5; ++i) t[i] = x[i] + dt * k3[i];
  unicycle_f(t, u, k4);
  for (int i = 0; i < 5; ++i)
    out[i] = x[i] + dt / 6.0 * (k1[i] + 2 * k2[i] + 2 * k3[i] + k4[i]);
}

// Fixed-point IRK (3-stage Radau IIA, robot_sim.py:25-29 config) for the
// unicycle; `iters` functional iterations (the dynamics are mildly stiff at
// worst, convergence is fast at dt=0.1).
void unicycle_irk3(const double* x, const double* u, double dt, int iters,
                   double* out) {
  static const double A3[3][3] = {
      {0.19681547722366044, -0.06553542585019838, 0.02377097434822015},
      {0.39442431473908913, 0.29207341166522843, -0.04154875212599793},
      {0.37640306270046725, 0.51248582618842153, 0.1111111111111111}};
  static const double b3[3] = {0.37640306270046725, 0.51248582618842153,
                               0.1111111111111111};
  double K[3][5], Z[5];
  unicycle_f(x, u, K[0]);
  std::memcpy(K[1], K[0], sizeof(K[0]));
  std::memcpy(K[2], K[0], sizeof(K[0]));
  for (int it = 0; it < iters; ++it) {
    for (int s = 0; s < 3; ++s) {
      for (int i = 0; i < 5; ++i) {
        double acc = x[i];
        for (int j = 0; j < 3; ++j) acc += dt * A3[s][j] * K[j][i];
        Z[i] = acc;
      }
      unicycle_f(Z, u, K[s]);
    }
  }
  for (int i = 0; i < 5; ++i) {
    double acc = x[i];
    for (int j = 0; j < 3; ++j) acc += dt * b3[j] * K[j][i];
    out[i] = acc;
  }
}

// RK4 step + exact sensitivities A = dPhi/dx (5x5), B = dPhi/du (5x2) for
// the unicycle, by forward-mode propagation of the 5x7 tangent [dx | du]
// through the four stages (the native analogue of jax.jacfwd through
// ops/integrators.rk4_step).
void unicycle_rk4_sens(const double* x, const double* u, double dt,
                       double* out, double* A_out, double* B_out) {
  auto jac = [](const double* s, double J[5][7]) {
    // continuous-time Jacobians: Jx columns 0..4, Ju columns 5..6
    for (int i = 0; i < 5; ++i)
      for (int j = 0; j < 7; ++j) J[i][j] = 0.0;
    double psi = s[2], v = s[3];
    J[0][2] = -v * std::sin(psi);
    J[0][3] = std::cos(psi);
    J[1][2] = v * std::cos(psi);
    J[1][3] = std::sin(psi);
    J[2][4] = 1.0;
    J[3][5] = 1.0;
    J[4][6] = 1.0;
  };
  // tangent of a stage state: T = I7_rows (dx part identity, du part zero
  // for state rows) ... propagate D(t_i) (5x7) and Dk_i = J(t_i) * [D; E]
  // where E is the 2x7 selector of the u columns (u does not vary within
  // the step).
  double k[4][5], Dk[4][5][7], t[5], Dt[5][7], J[5][7];
  const double coef[4] = {0.0, 0.5, 0.5, 1.0};
  for (int st = 0; st < 4; ++st) {
    if (st == 0) {
      for (int i = 0; i < 5; ++i) {
        t[i] = x[i];
        for (int j = 0; j < 7; ++j) Dt[i][j] = (i == j) ? 1.0 : 0.0;
      }
    } else {
      for (int i = 0; i < 5; ++i) {
        t[i] = x[i] + coef[st] * dt * k[st - 1][i];
        for (int j = 0; j < 7; ++j)
          Dt[i][j] = ((i == j) ? 1.0 : 0.0)
                     + coef[st] * dt * Dk[st - 1][i][j];
      }
    }
    unicycle_f(t, u, k[st]);
    jac(t, J);
    for (int i = 0; i < 5; ++i)
      for (int j = 0; j < 7; ++j) {
        double s2 = J[i][5] * ((j == 5) ? 1.0 : 0.0)
                    + J[i][6] * ((j == 6) ? 1.0 : 0.0);
        for (int m = 0; m < 5; ++m) s2 += J[i][m] * Dt[m][j];
        Dk[st][i][j] = s2;
      }
  }
  for (int i = 0; i < 5; ++i) {
    out[i] = x[i] + dt / 6.0 * (k[0][i] + 2 * k[1][i] + 2 * k[2][i]
                                + k[3][i]);
    for (int j = 0; j < 7; ++j) {
      double d = ((i == j) ? 1.0 : 0.0)
                 + dt / 6.0 * (Dk[0][i][j] + 2 * Dk[1][i][j]
                               + 2 * Dk[2][i][j] + Dk[3][i][j]);
      if (j < 5) A_out[i * 5 + j] = d;
      else       B_out[i * 2 + (j - 5)] = d;
    }
  }
}

// ---------------------------------------------------------------------------
// Standalone native closed-loop RTI runtime.
//
// The full controller tick loop of sim/closed_loop.py (itself mirroring
// RobotOcpProblem.step, robot_ocp_problem.py:168-258) implemented
// independently in C++: obstacle forecast (exact wall bounce,
// visualization.py:35-79), Gauss-Newton QP assembly with the dt-scaled
// LINEAR_LS cost + LM + distance-scaled slack weights
// (robot_ocp_problem.py:60-84,128,145-152), the Mehrotra interior point
// above, RK4 plant step, and the warm-start shift. Serves as
//   (a) the host-only production runtime (no accelerator needed), and
//   (b) an INDEPENDENT end-to-end oracle for the JAX loop
//       (tests/test_native.py::test_native_closed_loop_oracle) — nothing
//       here shares code with the JAX path beyond this file's IP solver,
//       which is itself cross-checked per-call against ops/ip_qp.
//
// Inputs: spec/cost scalars; x0 (5); goal (2); obst_pos/obst_vel (M*2);
// noise (T*M*2 standard-normal draws, or NULL for noise-free worlds);
// flags: bit0 cost_scale_dt, bit1 slack_scale_dt, bit2 lm_scale_dt,
// bit3 compat_pred_bug.
// Outputs: x_hist ((T+1)*5), u_hist (T*2) (zero-filled after the goal is
// reached), min_margin/steps/reached summary. Returns ticks simulated.
int ocp_closed_loop_run(
    int N, int M, int T, int qp_iter, double dt,
    double x_min, double x_max, double y_min, double y_max,
    double r_obst, double r_robot, double margin, double tol_goal,
    double randomness, double v_max_obst,
    const double* q_diag, const double* r_diag, const double* qe_diag,
    double lm, double slack_scale, double slack_offset,
    double x_bound, double v_bound, double u_bound,
    const double* x0_in, const double* goal,
    const double* obst_pos_in, const double* obst_vel_in,
    const double* noise, int flags,
    double ip_tau, double ip_reg, double ip_tol, double ip_stat_tol,
    double* x_hist, double* u_hist,
    double* min_margin_out, int* steps_out, int* reached_out) {
  const int nx = 5, nu = 2, nbx = 4, st = N + 1;
  const int idxbx[4] = {0, 1, 3, 4};
  const bool cost_sc = flags & 1, slack_sc = flags & 2, lm_sc = flags & 4,
             pred_bug = flags & 8;
  const double safe_sq = (r_obst + r_robot + margin) * (r_obst + r_robot
                                                        + margin);
  const double BIG = 1e6;

  std::vector<double> xg(st * nx), ug(N * nu, 0.0);   // warm start
  std::vector<double> x0(x0_in, x0_in + nx);
  std::vector<double> opos(obst_pos_in, obst_pos_in + 2 * M);
  std::vector<double> ovel(obst_vel_in, obst_vel_in + 2 * M);

  // cold start (set_initial_guess, robot_ocp_problem.py:301-306)
  for (int k = 0; k < st; ++k) {
    for (int i = 0; i < nx; ++i) xg[k * nx + i] = (i < 3) ? x0[i] : 0.0;
  }

  // one noise-free bounce step of (p, v) in-place (visualization.py:35-60)
  auto bounce = [&](double* p, double* v) {
    for (int ax = 0; ax < 2; ++ax) {
      double lo = ax ? y_min : x_min, hi = ax ? y_max : x_max;
      double pv = p[ax], vv = v[ax], t_hit;
      if (vv < 0) t_hit = (pv - lo) / std::abs(vv);
      else if (vv > 0) t_hit = (hi - pv) / std::abs(vv);
      else t_hit = 1e300;
      if (t_hit <= dt) {
        p[ax] = pv + vv * t_hit - vv * (dt - t_hit);
        v[ax] = -vv;
      } else {
        p[ax] = pv + vv * dt;
      }
    }
  };

  std::vector<double> P(st * M * 2);                   // forecast
  std::vector<double> A(N * nx * nx), B(N * nx * nu), c(N * nx), dx0(nx);
  std::vector<double> Q(st * nx * nx), q(st * nx), R(N * nu * nu),
      r(N * nu), S(N * nu * nx, 0.0);
  std::vector<double> lb_u(N * nu), ub_u(N * nu), lb_x(st * nbx),
      ub_x(st * nbx);
  std::vector<double> C(st * M * nx), hval(st * M), zl(st * M), Zl(st * M);
  std::vector<double> dx(st * nx), du(N * nu), s(st * M);

  double min_margin = 1e300;
  int steps = 0, reached = 0;
  for (int i = 0; i < nx; ++i) x_hist[i] = x0[i];
  std::memset(u_hist, 0, sizeof(double) * T * nu);
  for (int k = 1; k <= T; ++k)
    std::memset(&x_hist[k * nx], 0, sizeof(double) * nx);

  int tick = 0;
  for (; tick < T; ++tick) {
    // ---- 1. obstacle forecast over the horizon (parameterize_model) ----
    for (int o = 0; o < M; ++o) {
      double p[2] = {opos[2 * o], opos[2 * o + 1]};
      // the reference's line-69 typo seeds the prediction with vx = vy
      double v[2] = {pred_bug ? ovel[2 * o + 1] : ovel[2 * o],
                     ovel[2 * o + 1]};
      P[(0 * M + o) * 2] = p[0];
      P[(0 * M + o) * 2 + 1] = p[1];
      for (int kk = 1; kk <= N; ++kk) {
        bounce(p, v);
        P[(kk * M + o) * 2] = p[0];
        P[(kk * M + o) * 2 + 1] = p[1];
      }
    }

    // ---- 2. Gauss-Newton QP assembly (sqp_rti.build_qp) ----------------
    for (int kk = 0; kk < N; ++kk) {
      double phi[5];
      unicycle_rk4_sens(&xg[kk * nx], &ug[kk * nu], dt, phi,
                        &A[kk * nx * nx], &B[kk * nx * nu]);
      for (int i = 0; i < nx; ++i)
        c[kk * nx + i] = phi[i] - xg[(kk + 1) * nx + i];
    }
    for (int i = 0; i < nx; ++i) dx0[i] = x0[i] - xg[i];

    double dsel[4];
    for (int j = 0; j < nbx; ++j)
      dsel[j] = x0[idxbx[j]] - ((j == 0) ? goal[0] : (j == 1) ? goal[1]
                                                              : 0.0);
    double scale = slack_scale * (dsel[0] * dsel[0] + dsel[1] * dsel[1]
                                  + dsel[2] * dsel[2] + dsel[3] * dsel[3]
                                  + slack_offset);

    for (int kk = 0; kk < st; ++kk) {
      const bool terminal = (kk == N);
      const double sc = terminal ? 1.0 : (cost_sc ? dt : 1.0);
      const double lmk = terminal ? lm : (lm_sc ? sc * lm : lm);
      const double* w = terminal ? qe_diag : q_diag;
      double wfull[5] = {w[0], w[1], 0.0, w[2], w[3]};  // IDXBX scatter
      for (int i = 0; i < nx; ++i) {
        for (int j = 0; j < nx; ++j)
          Q[kk * nx * nx + i * nx + j] =
              (i == j) ? sc * wfull[i] + lmk : 0.0;
        double yref = (i == 0) ? goal[0] : (i == 1) ? goal[1] : 0.0;
        q[kk * nx + i] = sc * wfull[i] * (xg[kk * nx + i] - yref);
      }
      if (!terminal) {
        for (int i = 0; i < nu; ++i) {
          for (int j = 0; j < nu; ++j)
            R[kk * nu * nu + i * nu + j] =
                (i == j) ? sc * r_diag[i] + lmk : 0.0;
          r[kk * nu + i] = sc * r_diag[i] * ug[kk * nu + i];
          lb_u[kk * nu + i] = -u_bound - ug[kk * nu + i];
          ub_u[kk * nu + i] = u_bound - ug[kk * nu + i];
        }
      }
      // state box on stages 1..N-1 only (robot_ocp_problem.py:87-97)
      for (int j = 0; j < nbx; ++j) {
        double bnd = (j < 2) ? x_bound : v_bound;
        double gv = xg[kk * nx + idxbx[j]];
        bool inner = (kk >= 1 && kk <= N - 1);
        lb_x[kk * nbx + j] = inner ? -bnd - gv : -BIG;
        ub_x[kk * nbx + j] = inner ? bnd - gv : BIG;
      }
      // soft obstacle rows + distance-scaled stage-discounted slack
      double alpha = scale * double(N - kk) / double(N);
      double zv = (slack_sc ? sc : 1.0) * alpha;
      for (int o = 0; o < M; ++o) {
        double ddx = xg[kk * nx] - P[(kk * M + o) * 2];
        double ddy = xg[kk * nx + 1] - P[(kk * M + o) * 2 + 1];
        hval[kk * M + o] = ddx * ddx + ddy * ddy - safe_sq;
        double* Crow = &C[(kk * M + o) * nx];
        Crow[0] = 2.0 * ddx;
        Crow[1] = 2.0 * ddy;
        Crow[2] = Crow[3] = Crow[4] = 0.0;
        zl[kk * M + o] = zv;
        Zl[kk * M + o] = zv;
      }
    }

    // ---- objective normalization (ops/ocp_qp.normalize_cost) -----------
    double kappa = 1.0;
    for (int i = 0; i < st * nx; ++i)
      kappa = std::max(kappa, std::abs(Q[(i / nx) * nx * nx
                                         + (i % nx) * nx + (i % nx)]));
    for (int kk = 0; kk < N; ++kk)
      for (int i = 0; i < nu; ++i)
        kappa = std::max(kappa, std::abs(R[kk * nu * nu + i * nu + i]));
    for (int i = 0; i < st * M; ++i) {
      kappa = std::max(kappa, zl[i]);
      kappa = std::max(kappa, Zl[i]);
    }
    double inv = 1.0 / kappa;
    for (auto* vptr : {&Q, &q, &R, &r, &S, &zl, &Zl})
      for (double& v2 : *vptr) v2 *= inv;

    // ---- 3. interior-point solve ---------------------------------------
    double mu, stat;
    ocp_ip_solve(N, nx, nu, M, nbx, idxbx, A.data(), B.data(), c.data(),
                 dx0.data(), Q.data(), q.data(), R.data(), r.data(),
                 S.data(), lb_u.data(), ub_u.data(), lb_x.data(),
                 ub_x.data(), C.data(), hval.data(), zl.data(), Zl.data(),
                 qp_iter, ip_tau, ip_reg, ip_tol, ip_stat_tol, 1e12,
                 dx.data(), du.data(), s.data(), &mu, &stat);
    for (int i = 0; i < st * nx; ++i) xg[i] += dx[i];
    for (int i = 0; i < N * nu; ++i) ug[i] += du[i];
    double u0[2] = {ug[0], ug[1]};

    // ---- 4. plant step (RK4) -------------------------------------------
    double x_new[5];
    unicycle_rk4(x0.data(), u0, dt, x_new);

    // ---- 5. noisy obstacle world step (visualization.py:20-33) ---------
    for (int o = 0; o < M; ++o) {
      if (noise) {
        for (int ax = 0; ax < 2; ++ax) {
          double nz = noise[(tick * M + o) * 2 + ax];
          double v2 = (1.0 + randomness * nz) * ovel[2 * o + ax];
          ovel[2 * o + ax] = std::min(std::max(v2, -v_max_obst),
                                      v_max_obst);
        }
      }
      bounce(&opos[2 * o], &ovel[2 * o]);
    }

    // ---- 6. metrics ----------------------------------------------------
    for (int o = 0; o < M; ++o) {
      double ddx = x_new[0] - opos[2 * o], ddy = x_new[1] - opos[2 * o + 1];
      double mg = std::sqrt(ddx * ddx + ddy * ddy) - (r_obst + r_robot);
      min_margin = std::min(min_margin, mg);
    }
    std::memcpy(x0.data(), x_new, sizeof(x_new));
    std::memcpy(&x_hist[(tick + 1) * nx], x_new, sizeof(x_new));
    u_hist[tick * nu] = u0[0];
    u_hist[tick * nu + 1] = u0[1];
    double gdx = x_new[0] - goal[0], gdy = x_new[1] - goal[1];
    if (std::sqrt(gdx * gdx + gdy * gdy) <= tol_goal) {
      reached = 1;
      ++tick;
      break;
    }
    ++steps;

    // ---- 7. warm-start shift (robot_ocp_problem.py:253-258) ------------
    for (int kk = 0; kk < N; ++kk)
      std::memcpy(&xg[kk * nx], &xg[(kk + 1) * nx], sizeof(double) * nx);
    for (int kk = 0; kk + 1 < N; ++kk)
      std::memcpy(&ug[kk * nu], &ug[(kk + 1) * nu], sizeof(double) * nu);
    ug[(N - 1) * nu] = 0.0;
    ug[(N - 1) * nu + 1] = 0.0;
  }

  *min_margin_out = min_margin;
  *steps_out = steps;
  *reached_out = reached;
  return tick;
}

}  // extern "C"
