"""MT19937 compat streams: exact reproduction of the reference's seeded
draw order (experiments.py:33 -> obstacle_generator.py:11-22 ->
visualization.py:31)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from doa_mpc_tpu.config import SolverOptions, WorldSpec, default_cost_params
from doa_mpc_tpu.sim.compat_rng import mt_experiment_batch, mt_experiment_streams
from doa_mpc_tpu.sim.closed_loop import init_loop_state, make_batched_rollout
from doa_mpc_tpu.sim.obstacles import robot_start_goal
from doa_mpc_tpu.solver.sqp_rti import make_rti_controller


SPEC = WorldSpec(tf=2.0, n_solv=20, qp_iter=4)


def _reference_draws(seed, m, spec, ticks):
    """Emulate the reference's global-RandomState draw sequence verbatim:
    seed -> 4 uniform blocks -> per tick, per obstacle, normal(size=2)."""
    np.random.seed(seed)
    xlo, xhi, ylo, yhi = spec.obst_box
    x = np.random.uniform(xlo, xhi, (m, 1))
    y = np.random.uniform(ylo, yhi, (m, 1))
    v = spec.v_max_obst
    vx = np.random.uniform(-v, v, (m, 1))
    vy = np.random.uniform(-v, v, (m, 1))
    noise = np.empty((ticks, m, 2))
    for t in range(ticks):
        for j in range(m):
            noise[t, j] = np.random.normal(size=2)
    return np.hstack([x, y]), np.hstack([vx, vy]), noise


@pytest.mark.parametrize("seed", [0, 7, 99])
def test_stream_matches_reference_order(seed):
    obst, noise = mt_experiment_streams(seed, SPEC, "RANDOM", max_iter=17,
                                        dtype=np.float64)
    pos_ref, vel_ref, noise_ref = _reference_draws(seed, SPEC.n_obst, SPEC, 17)
    np.testing.assert_array_equal(obst.pos, pos_ref)
    np.testing.assert_array_equal(obst.vel, vel_ref)
    np.testing.assert_array_equal(noise, noise_ref)


def test_center_edge_skip_position_draws():
    # CENTER/EDGE draw only velocities; the noise stream then starts two
    # uniform blocks earlier (obstacle_generator.py:13-18 skips x/y)
    np.random.seed(3)
    v = SPEC.v_max_obst
    vx = np.random.uniform(-v, v, (SPEC.n_obst, 1))
    vy = np.random.uniform(-v, v, (SPEC.n_obst, 1))
    first = np.random.normal(size=2)
    obst, noise = mt_experiment_streams(3, SPEC, "EDGE", max_iter=2,
                                        dtype=np.float64)
    np.testing.assert_array_equal(obst.pos, np.full((SPEC.n_obst, 2), 7.0))
    np.testing.assert_array_equal(obst.vel, np.hstack([vx, vy]))
    np.testing.assert_array_equal(noise[0, 0], first)


def test_batch_stacks_per_seed_streams():
    obst, noise = mt_experiment_batch([0, 7], SPEC, "RANDOM", max_iter=5)
    o7, n7 = mt_experiment_streams(7, SPEC, "RANDOM", max_iter=5)
    np.testing.assert_array_equal(obst.pos[1], o7.pos)
    assert noise.shape == (5, 2, SPEC.n_obst, 2)
    np.testing.assert_array_equal(noise[:, 1], n7)


def test_rollout_consumes_noise_stream():
    ticks = 6
    spec = SPEC
    opts = SolverOptions(qp_iter=4, integrator="rk4")
    ctrl = make_rti_controller(spec, opts)
    params = default_cost_params(spec)
    start, goal = robot_start_goal(spec)
    seeds = [0, 1]
    obst, noise = mt_experiment_batch(seeds, spec, "RANDOM", max_iter=ticks)
    st0 = init_loop_state(jax.random.PRNGKey(0), ctrl, start, goal,
                          batch_shape=(len(seeds),), obst=obst)
    np.testing.assert_allclose(np.asarray(st0.obst.pos), obst.pos, rtol=1e-6)
    roll = jax.jit(make_batched_rollout(ctrl, goal, params, max_iter=ticks,
                                        use_noise_traj=True))
    f1 = roll(st0, jnp.asarray(noise))
    f2 = roll(st0, jnp.asarray(noise))
    np.testing.assert_array_equal(np.asarray(f1.x0), np.asarray(f2.x0))
    # a different stream must move the world differently
    f3 = roll(st0, jnp.asarray(noise) + 0.3)
    assert np.abs(np.asarray(f1.obst.pos) - np.asarray(f3.obst.pos)).max() > 1e-4
