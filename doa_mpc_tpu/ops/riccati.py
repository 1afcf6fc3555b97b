"""Block-tridiagonal Riccati factorization for OCP-structured Newton systems.

This is the structural replacement for HPIPM's partial-condensing +
block-banded KKT factorization (selected by the reference at
``robot_ocp_problem.py:126``: ``qp_solver='PARTIAL_CONDENSING_HPIPM'``).
Instead of condensing, the equality-constrained LQR subproblem arising at
each interior-point iteration is solved by a backward Riccati sweep and a
forward rollout — mathematically the same block-tridiagonal Cholesky, but
expressed as a ``lax.scan`` so XLA fuses the tiny (5x5 / 2x2) stage algebra
and batches it across thousands of scenarios under ``vmap``.

Factorization and back-substitution are split so one factorization serves
multiple right-hand sides per interior-point iteration (Mehrotra predictor +
corrector reuse the same stage Hessians).

Problem solved (single scenario; batch via ``vmap``):

    min   sum_k 1/2 x_k'Q_k x_k + q_k'x_k + 1/2 u_k'R_k u_k + r_k'u_k
          + u_k'S_k x_k          (k = 0..N-1, terminal k=N has Q, q only)
    s.t.  x_{k+1} = A_k x_k + B_k u_k + d_k,      x_0 given.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve


class RiccatiFactors(NamedTuple):
    """Backward-sweep products reused across right-hand sides.

    ``P``: (N+1, nx, nx) cost-to-go Hessians; ``Luu``: (N, nu, nu) Cholesky
    factors of Huu_k = R_k + B_k' P_{k+1} B_k; ``K``: (N, nu, nx) feedback
    gains; ``A``/``B`` are carried for the solve pass.
    """

    P: jnp.ndarray
    Luu: jnp.ndarray
    K: jnp.ndarray
    A: jnp.ndarray
    B: jnp.ndarray


def riccati_factorize(Q, R, S, A, B, reg: float = 0.0) -> RiccatiFactors:
    """Backward Riccati sweep over the stage Hessians.

    Args (single scenario): Q (N+1, nx, nx), R (N, nu, nu), S (N, nu, nx),
    A (N, nx, nx), B (N, nx, nu). ``reg`` is a static jitter added to Huu
    before the Cholesky (f32 robustness).
    """
    nu = R.shape[-1]
    eye_u = jnp.eye(nu, dtype=R.dtype)

    def backward(P_next, inp):
        Qk, Rk, Sk, Ak, Bk = inp
        PB = P_next @ Bk                                  # (nx, nu)
        Huu = Rk + Bk.T @ PB + reg * eye_u
        Huu = 0.5 * (Huu + Huu.T)
        Lc = cho_factor(Huu, lower=True)[0]
        Hux = Sk + Bk.T @ (P_next @ Ak)                   # (nu, nx)
        K = -cho_solve((Lc, True), Hux)                   # (nu, nx)
        P = Qk + Ak.T @ (P_next @ Ak) + Hux.T @ K
        P = 0.5 * (P + P.T)
        return P, (P, Lc, K)

    P_N = 0.5 * (Q[-1] + jnp.swapaxes(Q[-1], -1, -2))
    _, (P_rest, Luu, K) = jax.lax.scan(
        backward, P_N, (Q[:-1], R, S, A, B), reverse=True
    )
    P = jnp.concatenate([P_rest, P_N[None]], axis=0)
    return RiccatiFactors(P=P, Luu=Luu, K=K, A=A, B=B)


def riccati_solve(fac: RiccatiFactors, q, r, d, x0):
    """Back-substitution for one right-hand side.

    Args: q (N+1, nx), r (N, nu), d (N, nx) dynamics affine terms, x0 (nx,)
    fixed initial state. Returns (x (N+1, nx), u (N, nu), nu_dyn (N, nx))
    where ``nu_dyn[k]`` is the multiplier of the k-th dynamics constraint
    (the LQR costate P_{k+1} x_{k+1} + p_{k+1}) — needed by the
    interior-point caller to maintain stationarity residuals.
    """
    A, B, P, Luu, K = fac.A, fac.B, fac.P, fac.Luu, fac.K

    def backward(p_next, inp):
        qk, rk, dk, Ak, Bk, P_next, Lc, Kk = inp
        Pd_p = P_next @ dk + p_next                       # (nx,)
        m = rk + Bk.T @ Pd_p                              # (nu,)
        kff = -cho_solve((Lc, True), m)
        p = qk + Ak.T @ Pd_p + Kk.T @ m
        return p, (kff, p_next)

    _, (kff, p_seq) = jax.lax.scan(
        backward, q[-1], (q[:-1], r, d, A, B, P[1:], Luu, K), reverse=True
    )
    # p_seq[k] = p_{k+1} (outputs come back in forward stage order)

    def forward(xk, inp):
        Ak, Bk, dk, Kk, kffk = inp
        uk = Kk @ xk + kffk
        x_next = Ak @ xk + Bk @ uk + dk
        return x_next, (xk, uk)

    xN, (xs, us) = jax.lax.scan(forward, x0, (A, B, d, K, kff))
    x = jnp.concatenate([xs, xN[None]], axis=0)
    # Multiplier of constraint k (x_{k+1} - A x_k - B u_k - d_k = 0) under
    # the convention  Q x_k + q_k + nu_{k-1} - A' nu_k = 0:
    # nu_k = -(P_{k+1} x_{k+1} + p_{k+1})  (negative value-function gradient).
    nu_dyn = -(jnp.einsum("kij,kj->ki", P[1:], x[1:]) + p_seq)
    return x, us, nu_dyn
