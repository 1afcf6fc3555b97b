"""OCP-structured QP data container.

The per-tick quadratic program that the reference hands to
acados/HPIPM (``robot_ocp_problem.py:195`` -> RTI linearize -> partial
condense -> HPIPM), expressed as plain arrays in the delta variables around
the current SQP linearization point:

    min   sum_{k=0}^{N-1} 1/2 dz_k' H_k dz_k + g_k' dz_k
          + 1/2 dx_N' Q_N dx_N + q_N' dx_N
          + sum_{k,i} zl[k,i] * s[k,i] + 1/2 * Zl[k,i] * s[k,i]^2
    s.t.  dx_{k+1} = A_k dx_k + B_k du_k + c_k,     dx_0 = dx0   (fixed)
          lb_u <= du_k <= ub_u                                   (hard box)
          lb_x <= E dx_k <= ub_x          E selects idxbx        (hard box)
          hval[k] + C_k dx_k + s_k >= 0,  s_k >= 0               (soft)

All arrays are single-scenario; the solver is ``vmap``-ed over a leading
batch axis. Stage counts are static (shapes fix N, M); stages where a
constraint does not apply (x-box at k=0 and k=N per acados convention, cf.
``robot_ocp_problem.py:87-97``) use +-``BIG_BOUND`` so the rows exist but
can never activate — masking by data, not by shape.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

# Inactive box rows get this bound; 1e6 keeps sigma = lambda/t harmless in f32.
BIG_BOUND = 1e6

# State indices carrying the +-7 / +-V_MAX box (robot_ocp_problem.py:92-94).
IDXBX = (0, 1, 3, 4)


class OcpQp(NamedTuple):
    """One scenario's QP data. Shapes (N = horizon, M = n. soft constraints):

    dynamics:  A (N, nx, nx), B (N, nx, nu), c (N, nx), dx0 (nx,)
    cost:      Q (N+1, nx, nx), q (N+1, nx), R (N, nu, nu), r (N, nu),
               S (N, nu, nx)
    u box:     lb_u, ub_u (N, nu)
    x box:     lb_x, ub_x (N+1, nbx) on the IDXBX selection
    soft:      C (N+1, M, nx), hval (N+1, M), zl, Zl (N+1, M)
    """

    A: jnp.ndarray
    B: jnp.ndarray
    c: jnp.ndarray
    dx0: jnp.ndarray
    Q: jnp.ndarray
    q: jnp.ndarray
    R: jnp.ndarray
    r: jnp.ndarray
    S: jnp.ndarray
    lb_u: jnp.ndarray
    ub_u: jnp.ndarray
    lb_x: jnp.ndarray
    ub_x: jnp.ndarray
    C: jnp.ndarray
    hval: jnp.ndarray
    zl: jnp.ndarray
    Zl: jnp.ndarray

    @property
    def horizon(self) -> int:
        return self.A.shape[-3]

    @property
    def nx(self) -> int:
        return self.A.shape[-1]

    @property
    def nu(self) -> int:
        return self.B.shape[-1]


def normalize_cost(qp: OcpQp) -> tuple[OcpQp, jnp.ndarray]:
    """Scale the objective by 1/kappa so its largest coefficient is O(1).

    The reference's distance-scaled slack penalties reach ~1e6
    (``robot_ocp_problem.py:146``: 1e4 * (dist^2 + 50)) while R has entries
    0.15 — a 1e7 spread that is hostile to f32 interior-point iterations.
    Scaling the whole objective by a positive scalar leaves the primal
    minimizer unchanged (duals scale by kappa). Returns the scaled QP and
    kappa.
    """
    bnd = qp.A.ndim - 3            # leading batch axes (0 or 1)

    def rmax(a):
        return jnp.max(a, axis=tuple(range(bnd, a.ndim)))

    def bc(s, a):
        return jnp.reshape(s, s.shape + (1,) * (a.ndim - s.ndim))

    kappa = jnp.maximum(
        jnp.maximum(rmax(jnp.abs(jnp.diagonal(qp.Q, axis1=-2, axis2=-1))),
                    rmax(jnp.abs(jnp.diagonal(qp.R, axis1=-2, axis2=-1)))),
        jnp.maximum(jnp.maximum(rmax(qp.zl), rmax(qp.Zl)),
                    jnp.ones(qp.A.shape[:bnd], qp.Q.dtype)))
    inv = 1.0 / kappa
    return qp._replace(
        Q=qp.Q * bc(inv, qp.Q), q=qp.q * bc(inv, qp.q),
        R=qp.R * bc(inv, qp.R), r=qp.r * bc(inv, qp.r),
        S=qp.S * bc(inv, qp.S),
        zl=qp.zl * bc(inv, qp.zl), Zl=qp.Zl * bc(inv, qp.Zl),
    ), kappa
