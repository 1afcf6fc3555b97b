"""Integrator unit tests.

The reference's only integrator harness is the manual open-loop demo
``src/simulation/robot_sim.py`` (IRK GAUSS_RADAU_IIA, 3 stages / 3 Newton
iters). Here: tableau identities, convergence order vs a very fine RK4
reference, closed-form checks on the unicycle, and batching consistency.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from doa_mpc_tpu.models.unicycle import dynamics
from doa_mpc_tpu.ops.integrators import butcher_tableau, irk_step, rk4_step


def test_tableau_row_sums():
    # For collocation methods, sum_j A_ij = c_i and sum b_j = 1.
    for kind, s in [("gauss_legendre", 2), ("gauss_legendre", 3),
                    ("gauss_legendre", 4), ("radau_iia", 2), ("radau_iia", 3)]:
        A, b, c = butcher_tableau(kind, s)
        np.testing.assert_allclose(A.sum(axis=1), c, atol=1e-12)
        np.testing.assert_allclose(b.sum(), 1.0, atol=1e-12)


def test_radau3_matches_known_tableau():
    # 3-stage Radau IIA has a known closed form (Hairer & Wanner Table 5.6).
    A, b, c = butcher_tableau("radau_iia", 3)
    s6 = np.sqrt(6.0)
    A_ref = np.array([
        [(88 - 7 * s6) / 360, (296 - 169 * s6) / 1800, (-2 + 3 * s6) / 225],
        [(296 + 169 * s6) / 1800, (88 + 7 * s6) / 360, (-2 - 3 * s6) / 225],
        [(16 - s6) / 36, (16 + s6) / 36, 1.0 / 9.0],
    ])
    np.testing.assert_allclose(A, A_ref, atol=1e-12)
    np.testing.assert_allclose(b, A_ref[-1], atol=1e-12)


def _straight_line_exact(x0, u, dt):
    """Closed form for psi'=0, omega=0: straight-line accel motion."""
    x, y, psi, v, om = x0
    a = u[0]
    return np.array([
        x + np.cos(psi) * (v * dt + 0.5 * a * dt**2),
        y + np.sin(psi) * (v * dt + 0.5 * a * dt**2),
        psi,
        v + a * dt,
        om + u[1] * dt,
    ])


def test_straight_line_closed_form():
    x0 = jnp.array([1.0, -2.0, 0.7, 3.0, 0.0])
    u = jnp.array([2.0, 0.0])
    dt = 0.1
    exact = _straight_line_exact(np.asarray(x0), np.asarray(u), dt)
    for got in [rk4_step(dynamics, x0, u, dt),
                irk_step(dynamics, x0, u, dt, stages=4, newton_iter=5)]:
        np.testing.assert_allclose(np.asarray(got), exact, atol=1e-10)


def _fine_reference(x0, u, dt):
    return rk4_step(dynamics, x0, u, dt, substeps=200)


@pytest.mark.parametrize("kind,stages,order", [
    ("gauss_legendre", 2, 4), ("gauss_legendre", 3, 6),
    ("radau_iia", 2, 3), ("radau_iia", 3, 5),
])
def test_irk_convergence_order(kind, stages, order):
    x0 = jnp.array([0.0, 0.0, 0.3, 2.0, 1.5], dtype=jnp.float64)
    u = jnp.array([1.0, -0.5], dtype=jnp.float64)
    errs = []
    dts = [0.2, 0.1]
    for dt in dts:
        ref = _fine_reference(x0, u, dt)
        got = irk_step(dynamics, x0, u, dt, stages=stages, newton_iter=12,
                       tableau=kind)
        errs.append(float(jnp.linalg.norm(got - ref)))
    rate = np.log2(errs[0] / errs[1])
    # observed order should be at least the theoretical stage order - slack
    assert rate > order - 0.8, (errs, rate)


def test_irk_matches_acados_config_tolerance():
    # 4-stage GL, 3 Newton iters (acados OCP defaults) at dt=0.1 must be
    # within 1e-9 of a dense reference on this smooth system.
    x0 = jnp.array([0.0, 0.0, 0.3, 2.0, 1.5], dtype=jnp.float64)
    u = jnp.array([1.0, -0.5], dtype=jnp.float64)
    dt = 0.1
    ref = _fine_reference(x0, u, dt)
    got = irk_step(dynamics, x0, u, dt, stages=4, newton_iter=3)
    assert float(jnp.linalg.norm(got - ref)) < 1e-9


def test_batched_matches_single():
    key = jax.random.PRNGKey(0)
    X = jax.random.normal(key, (16, 5), dtype=jnp.float64)
    U = jax.random.normal(jax.random.PRNGKey(1), (16, 2), dtype=jnp.float64)
    dt = 0.1
    batched = irk_step(dynamics, X, U, dt, stages=3, newton_iter=3)
    singles = jnp.stack([
        irk_step(dynamics, X[i], U[i], dt, stages=3, newton_iter=3)
        for i in range(16)
    ])
    np.testing.assert_allclose(np.asarray(batched), np.asarray(singles), atol=1e-12)


def test_sensitivities_via_jacfwd():
    # A = dPhi/dx must match finite differences.
    x0 = jnp.array([0.5, -0.2, 1.1, 2.0, 0.3], dtype=jnp.float64)
    u = jnp.array([0.7, -0.4], dtype=jnp.float64)
    dt = 0.1
    step = lambda x, u: irk_step(dynamics, x, u, dt, stages=4, newton_iter=3)
    A = jax.jacfwd(step, argnums=0)(x0, u)
    B = jax.jacfwd(step, argnums=1)(x0, u)
    eps = 1e-6
    for i in range(5):
        dx = jnp.zeros(5, jnp.float64).at[i].set(eps)
        fd = (step(x0 + dx, u) - step(x0 - dx, u)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(A[:, i]), np.asarray(fd), atol=1e-6)
    for i in range(2):
        du = jnp.zeros(2, jnp.float64).at[i].set(eps)
        fd = (step(x0, u + du) - step(x0, u - du)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(B[:, i]), np.asarray(fd), atol=1e-6)


def test_f32_accuracy_sufficient():
    # Production path runs f32 on the GPU; one tick must stay ~1e-5 of f64.
    x0 = jnp.array([0.5, -0.2, 1.1, 2.0, 0.3])
    u = jnp.array([0.7, -0.4])
    got32 = irk_step(dynamics, x0.astype(jnp.float32), u.astype(jnp.float32), 0.1)
    got64 = irk_step(dynamics, x0.astype(jnp.float64), u.astype(jnp.float64), 0.1)
    assert got32.dtype == jnp.float32
    assert float(jnp.max(jnp.abs(got32 - got64.astype(jnp.float32)))) < 1e-5
