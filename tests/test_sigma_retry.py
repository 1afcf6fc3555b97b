"""Self-recovery of rows wedged by the non-finite direction guard.

Background: on an accelerator whose default f32 matmul used
reduced-precision passes, ~1/256 mid-rollout production QPs overflowed the
condensed f32 Riccati at the sigma_max=1e7 barrier clamp (CPU f32 survives
the same rows). The non-finite guard then freezes the row with UNCHANGED state, which
reproduces the overflow every subsequent iteration — a permanent wedge. The
fix (``solve_ocp_qp(..., sigma_retry=...)``): a row that trips the guard
permanently lowers its own per-row curvature clamp and resumes on the next
iteration.

The overflow itself depends on the device's arithmetic, so this file carries
two layers:

- CPU tests that the retry path is quality-neutral on ordinary QPs and that
  the per-row cap machinery batches correctly;
- a regression on captured hard QPs
  (``tests/fixtures/hard_qps_f32.npz``, written by
  ``scripts/capture_hard_qps.py`` from real closed-loop rollouts): with
  retry the recorded rows must make interior-point progress where the
  retry-disabled solve stays wedged.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from doa_mpc_tpu.ops.ip_qp import solve_ocp_qp
from doa_mpc_tpu.ops.ocp_qp import OcpQp

from test_ip_qp import _make_qp  # noqa: E402  (tests dir on sys.path)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "hard_qps_f32.npz")


def _f32(qp):
    return jax.tree.map(lambda a: a.astype(jnp.float32), qp)


def test_retry_default_is_quality_neutral():
    """On QPs that never trip the guard the lowered-cap path must be dead:
    retry on/off give bit-identical solutions."""
    rng = np.random.default_rng(3)
    qps = [_f32(_make_qp(rng, N=10, seed_scale=s)) for s in (1.0, 3.0)]
    batched = jax.tree.map(lambda *ls: jnp.stack(ls), *qps)
    a = solve_ocp_qp(batched, iters=30, sigma_retry=0)
    b = solve_ocp_qp(batched, iters=30)          # retry enabled by default
    np.testing.assert_array_equal(np.asarray(a.dx), np.asarray(b.dx))
    np.testing.assert_array_equal(np.asarray(a.mu), np.asarray(b.mu))
    assert float(a.mu.max()) < 1e-6


def test_per_row_cap_is_isolated():
    """A row that trips the guard every iteration must not perturb healthy
    rows: with a poisoned row in the batch, retry on/off give bit-identical
    results for the healthy row (the lowered cap is per-row), and the
    poisoned row freezes finitely instead of spraying NaNs."""
    rng = np.random.default_rng(5)
    good = _f32(_make_qp(rng, N=8))
    # poison one row's data outright (inf cost gradient): its directions are
    # non-finite every iteration, tripping the guard each time
    bad = jax.tree.map(lambda a: jnp.copy(a), good)
    bad = bad._replace(q=bad.q.at[0, 0].set(jnp.inf))
    mixed = jax.tree.map(lambda g, b: jnp.stack([g, b]), good, bad)
    with_retry = solve_ocp_qp(mixed, iters=25)
    no_retry = solve_ocp_qp(mixed, iters=25, sigma_retry=0)
    np.testing.assert_array_equal(np.asarray(with_retry.dx[0]),
                                  np.asarray(no_retry.dx[0]))
    np.testing.assert_array_equal(np.asarray(with_retry.mu[0]),
                                  np.asarray(no_retry.mu[0]))
    assert float(with_retry.mu[0]) < 1e-6
    # the poisoned row froze at its initial iterate instead of spraying NaNs
    assert np.isfinite(np.asarray(with_retry.dx[1])).all()


@pytest.mark.skipif(not os.path.exists(FIXTURE),
                    reason="hard-QP fixture not captured yet "
                           "(scripts/capture_hard_qps.py)")
def test_recorded_hard_qps_recover():
    """The captured wedge QPs must make full IP progress.

    The fixture holds real closed-loop QPs that wedged the XLA f32 backend
    (mu stuck at its 1.0 initialization) where the default f32 matmul
    precision used reduced-precision passes, which overflow the condensed
    Riccati — ``solve_ocp_qp`` now forces full-f32 matmuls, which solves
    every recorded row (CPU f32 always did). The per-row ``sigma_retry``
    cap remains as a second-layer safety net. Runs on whatever backend jax
    selects.
    """
    data = np.load(FIXTURE)
    qp = OcpQp(*[jnp.asarray(data[f]) for f in OcpQp._fields])
    # these rows are genuinely hard (near-active soft constraints): give
    # the IP a realistic budget — the wedge signature this guards against
    # is mu FROZEN at 1.0 regardless of iterations, not slow convergence
    sol = solve_ocp_qp(qp, iters=50)
    assert float(np.max(np.asarray(sol.mu))) < 1e-2, (
        "captured hard rows did not recover "
        f"(mu={np.asarray(sol.mu)})")
