"""Jitted fixed-step integrators (the acados sim/IRK replacement).

The reference integrates both the OCP dynamics and the simulated plant with
acados' implicit-Runge-Kutta C integrator (``robot_ocp_problem.py:129,136``;
standalone demo at ``robot_sim.py:23-29`` uses 3-stage GAUSS_RADAU_IIA with 3
Newton iterations). Here the same numerics are a pure JAX function:

- collocation tableaus are built numerically on the host at trace time
  (Gauss-Legendre for any stage count, Radau IIA for s<=3),
- the implicit stage equations are solved with a *fixed* number of Newton
  iterations (static shapes; no data-dependent control flow) exactly like
  acados' ``newton_iter`` option,
- sensitivities A = dPhi/dx, B = dPhi/du come from ``jax.jacfwd`` through the
  unrolled Newton iterations — the autodiff analogue of acados' internal
  numerical differentiation, with no codegen step.

Everything broadcasts over leading batch dimensions; under ``vmap`` the
per-stage (s*nx x s*nx) Newton solves become batched 20x20 solves, factored
by the block LU below.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Butcher tableau construction (host-side, static)
# ---------------------------------------------------------------------------

def _collocation_tableau(c: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Build (A, b) of the collocation method with nodes ``c`` in (0, 1].

    A_ij = integral_0^{c_i} l_j(t) dt, b_j = integral_0^1 l_j(t) dt where l_j
    are the Lagrange basis polynomials on the nodes. Standard construction —
    see Hairer & Wanner, Solving ODEs II, Thm IV.5.2.
    """
    s = len(c)
    A = np.zeros((s, s))
    b = np.zeros(s)
    for j in range(s):
        # Lagrange basis polynomial l_j as coefficient array
        poly = np.poly1d([1.0])
        for k in range(s):
            if k != j:
                poly *= np.poly1d([1.0, -c[k]]) / (c[j] - c[k])
        integ = poly.integ()
        b[j] = integ(1.0) - integ(0.0)
        for i in range(s):
            A[i, j] = integ(c[i]) - integ(0.0)
    return A, b


# Radau IIA nodes (right endpoint included); s=3 matches acados
# GAUSS_RADAU_IIA num_stages=3 (robot_sim.py:25-29).
_RADAU_IIA_NODES = {
    1: np.array([1.0]),
    2: np.array([1.0 / 3.0, 1.0]),
    3: np.array([(4.0 - np.sqrt(6.0)) / 10.0, (4.0 + np.sqrt(6.0)) / 10.0, 1.0]),
}


@functools.lru_cache(maxsize=None)
def butcher_tableau(kind: str, stages: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (A, b, c) for the requested implicit collocation scheme."""
    if kind == "gauss_legendre":
        # Gauss-Legendre nodes on (0,1): shifted roots of P_s
        x, _ = np.polynomial.legendre.leggauss(stages)
        c = (x + 1.0) / 2.0
    elif kind == "radau_iia":
        if stages not in _RADAU_IIA_NODES:
            raise ValueError(f"radau_iia supported for stages<=3, got {stages}")
        c = _RADAU_IIA_NODES[stages]
    else:
        raise ValueError(f"unknown tableau kind {kind!r}")
    A, b = _collocation_tableau(np.asarray(c, dtype=np.float64))
    return A, b, np.asarray(c, dtype=np.float64)


# ---------------------------------------------------------------------------
# Explicit RK4
# ---------------------------------------------------------------------------

def rk4_step(f: Callable, x: jnp.ndarray, u: jnp.ndarray, dt, substeps: int = 1) -> jnp.ndarray:
    """Classic RK4 over ``dt`` with ``substeps`` equal sub-intervals."""
    h = dt / substeps
    def one(x):
        k1 = f(x, u)
        k2 = f(x + 0.5 * h * k1, u)
        k3 = f(x + 0.5 * h * k2, u)
        k4 = f(x + h * k3, u)
        return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    for _ in range(substeps):
        x = one(x)
    return x


# ---------------------------------------------------------------------------
# Implicit RK (collocation + fixed Newton)
# ---------------------------------------------------------------------------

def irk_step(
    f: Callable,
    x: jnp.ndarray,
    u: jnp.ndarray,
    dt,
    *,
    stages: int = 4,
    newton_iter: int = 3,
    tableau: str = "gauss_legendre",
    num_steps: int = 1,
) -> jnp.ndarray:
    """One implicit-RK step of size ``dt`` (optionally split into sub-steps).

    Solves the collocation equations K_i = f(x + dt * sum_j A_ij K_j, u) with
    ``newton_iter`` full-Newton iterations on the stacked stage-derivative
    vector K (shape (..., s, nx)), mirroring acados' IRK with fixed
    ``newton_iter`` (acados sim default: 4-stage Gauss-Legendre, 3 Newton
    iterations; ``robot_sim.py:25-29`` uses 3/3/3 Radau IIA).

    The Newton matrix (I - h * (A (x) J_f)) is rebuilt each iteration from
    the current stage states (acados freezes the Jacobian; rebuilding is
    cheap here and strictly more accurate) and factored by an unrolled
    BLOCK LU over its s x s grid of nx x nx blocks: M is an O(h L)
    perturbation of the identity, so pivoting is unnecessary, and the block
    factorization lowers to a handful of batched (nx, nx) matmuls instead
    of the sequential pivoted loop ``jnp.linalg.solve`` produces.

    Sensitivities use the implicit-function theorem (``jax.custom_jvp``)
    exactly like acados' IRK sensitivity computation: tangents solve the
    SAME collocation system M dK = [Jf_i dx + Ju_i du] at the converged
    stage states, instead of differentiating through the Newton recursion.
    Under ``jax.jacfwd`` the primal solve and block factorization are
    computed once (they do not depend on the tangent axis); only the cheap
    block-triangular solves repeat per direction.
    """
    A_np, b_np, _ = butcher_tableau(tableau, stages)
    A = jnp.asarray(A_np, dtype=x.dtype)
    b = jnp.asarray(b_np, dtype=x.dtype)
    nx = x.shape[-1]
    h = dt / num_steps

    def collocation_K(x, u):
        f0 = f(x, u)                                   # (..., nx)
        K = jnp.broadcast_to(f0[..., None, :], f0.shape[:-1] + (stages, nx))

        def newton(K, _):
            # stage states Z_i = x + h * sum_j A_ij K_j
            Z = x[..., None, :] + h * jnp.einsum("ij,...jn->...in", A, K)
            F = _stagewise(f, Z, u)                    # f at each stage state
            R = K - F                                  # residual (..., s, nx)
            Jf = _stagewise_jac(f, Z, u)               # (..., s, nx, nx)
            LU, invd = _block_lu(_newton_blocks(A, Jf, h))
            K = K - _block_solve(LU, invd, R)
            return K, None

        K, _ = jax.lax.scan(newton, K, None, length=newton_iter)
        return K

    @jax.custom_jvp
    def substep(x, u):
        K = collocation_K(x, u)
        return x + h * jnp.einsum("j,...jn->...n", b, K)

    @substep.defjvp
    def substep_jvp(primals, tangents):
        x, u = primals
        dx, du = tangents
        K = collocation_K(x, u)
        Z = x[..., None, :] + h * jnp.einsum("ij,...jn->...in", A, K)
        Jf = _stagewise_jac(f, Z, u)                   # (..., s, nx, nx)
        Ju = _stagewise_jac_u(f, Z, u)                 # (..., s, nx, nu)
        LU, invd = _block_lu(_newton_blocks(A, Jf, h))
        rhs = (jnp.einsum("...sij,...j->...si", Jf, dx)
               + jnp.einsum("...sij,...j->...si", Ju, du))
        dK = _block_solve(LU, invd, rhs)
        phi = x + h * jnp.einsum("j,...jn->...n", b, K)
        dphi = dx + h * jnp.einsum("j,...jn->...n", b, dK)
        return phi, dphi

    for _ in range(num_steps):
        x = substep(x, u)
    return x


def _inv_small(D: jnp.ndarray) -> jnp.ndarray:
    """Unrolled no-pivot Gauss-Jordan inverse of (..., n, n), n small."""
    n = D.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=D.dtype), D.shape)
    aug = jnp.concatenate([D, eye], axis=-1)
    for k in range(n):
        row = aug[..., k, :] / aug[..., k, k:k + 1]
        aug = aug.at[..., k, :].set(row)
        col = aug[..., :, k].at[..., k].set(0.0)
        aug = aug - col[..., :, None] * row[..., None, :]
    return aug[..., n:]


def _newton_blocks(A: jnp.ndarray, Jf: jnp.ndarray, h) -> jnp.ndarray:
    """Blocks of the collocation Newton matrix: (..., s, s, nx, nx) with
    M[i, j] = delta_ij I - h A_ij Jf_i (Jacobian of R_i = K_i - f(Z_i))."""
    s, nx = Jf.shape[-3], Jf.shape[-1]
    M = -h * A[:, :, None, None] * Jf[..., :, None, :, :]
    # static per-block diagonal add (no index-array scatter)
    eye = jnp.eye(nx, dtype=Jf.dtype)
    for k in range(s):
        M = M.at[..., k, k, :, :].add(eye)
    return M


def _block_lu(M: jnp.ndarray):
    """Block LU without pivoting of (..., s, s, nx, nx).

    Returns the packed factors (L with identity diagonal blocks strictly
    below, the Schur-complement U on/above) plus the list of inverted
    diagonal blocks (reused by every subsequent solve). Safe without
    pivoting because M = I - h (A (x) Jf) with ||h A Jf|| << 1.
    """
    s = M.shape[-4]
    invd = []
    for k in range(s):
        ik = _inv_small(M[..., k, k, :, :])
        invd.append(ik)
        for i in range(k + 1, s):
            Lik = M[..., i, k, :, :] @ ik
            M = M.at[..., i, k, :, :].set(Lik)
            for j in range(k + 1, s):
                M = M.at[..., i, j, :, :].add(-Lik @ M[..., k, j, :, :])
    return M, invd


def _block_solve(LU: jnp.ndarray, invd, r: jnp.ndarray) -> jnp.ndarray:
    """Solve the block-factored system for r of shape (..., s, nx)."""
    s = LU.shape[-4]
    y = []
    for i in range(s):                       # forward, unit-block-lower
        acc = r[..., i, :]
        for j in range(i):
            acc = acc - jnp.einsum("...ab,...b->...a",
                                   LU[..., i, j, :, :], y[j])
        y.append(acc)
    xs = [None] * s
    for k in reversed(range(s)):             # backward, block-upper
        acc = y[k]
        for j in range(k + 1, s):
            acc = acc - jnp.einsum("...ab,...b->...a",
                                   LU[..., k, j, :, :], xs[j])
        xs[k] = jnp.einsum("...ab,...b->...a", invd[k], acc)
    return jnp.stack(xs, axis=-2)


def _stagewise(f, Z, u):
    """Apply f at each of the s stage states; Z (..., s, nx), u (..., nu)."""
    u_b = jnp.broadcast_to(u[..., None, :], Z.shape[:-1] + (u.shape[-1],))
    return f(Z, u_b)


def _stagewise_jac(f, Z, u):
    """df/dx at each stage state -> (..., s, nx, nx)."""
    nx = Z.shape[-1]
    u_b = jnp.broadcast_to(u[..., None, :], Z.shape[:-1] + (u.shape[-1],))

    def single(z, uu):
        return jax.jacfwd(lambda zz: f(zz, uu))(z)

    flatZ = Z.reshape((-1, nx))
    flatU = u_b.reshape((-1, u.shape[-1]))
    J = jax.vmap(single)(flatZ, flatU)
    return J.reshape(Z.shape + (nx,))


def _stagewise_jac_u(f, Z, u):
    """df/du at each stage state -> (..., s, nx, nu)."""
    nx, nu = Z.shape[-1], u.shape[-1]
    u_b = jnp.broadcast_to(u[..., None, :], Z.shape[:-1] + (nu,))

    def single(z, uu):
        return jax.jacfwd(lambda vv: f(z, vv))(uu)

    J = jax.vmap(single)(Z.reshape((-1, nx)), u_b.reshape((-1, nu)))
    return J.reshape(Z.shape + (nu,))


def make_integrator(options, dtype=jnp.float32) -> Callable:
    """Build Phi(x, u, dt) from :class:`doa_mpc_tpu.config.SolverOptions`."""
    from doa_mpc_tpu.models.unicycle import dynamics

    if options.integrator == "rk4":
        def step(x, u, dt):
            return rk4_step(dynamics, x, u, dt)
    elif options.integrator == "irk":
        def step(x, u, dt):
            return irk_step(
                dynamics, x, u, dt,
                stages=options.irk_stages,
                newton_iter=options.irk_newton_iter,
                tableau=options.irk_tableau,
            )
    else:
        raise ValueError(f"unknown integrator {options.integrator!r}")
    return step
