"""Closed-loop RTI tests: goal reaching, bound satisfaction, batching.

Mirrors the reference's only systematic check — seeded Monte-Carlo runs of
``RobotOcpProblem.step(400)`` (experiments.py:32-36) — at test-friendly
sizes (N=10 horizon, reduced tick budgets).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from doa_mpc_tpu.config import WorldSpec, SolverOptions, default_cost_params
from doa_mpc_tpu.sim.closed_loop import (
    init_loop_state, make_rollout, make_tick, metrics_of,
)
from doa_mpc_tpu.sim.obstacles import ObstacleState, robot_start_goal
from doa_mpc_tpu.solver.sqp_rti import make_rti_controller

SPEC = WorldSpec(tf=1.0, n_solv=10, qp_iter=15)
OPTS = SolverOptions(qp_iter=15, integrator="rk4")


def _setup(dtype=jnp.float64):
    ctrl = make_rti_controller(SPEC, OPTS, dtype=dtype)
    params = default_cost_params(SPEC, dtype=dtype)
    start, goal = robot_start_goal(SPEC)
    return ctrl, params, start.astype(dtype), goal.astype(dtype)


def _parked_obstacles(spec, dtype):
    """Obstacles parked far from the start-goal diagonal, zero velocity."""
    pos = jnp.array([[-6.0, 6.0]] * spec.n_obst, dtype)
    vel = jnp.zeros((spec.n_obst, 2), dtype)
    return ObstacleState(pos, vel)


def test_reaches_goal_with_parked_obstacles():
    ctrl, params, start, goal = _setup()
    st = init_loop_state(jax.random.PRNGKey(0), ctrl, start, goal)
    st = st._replace(obst=_parked_obstacles(SPEC, jnp.float64))
    rollout = jax.jit(make_rollout(ctrl, goal, params, max_iter=120,
                                   random_move=False))
    fin = rollout(st)
    m = metrics_of(fin)
    assert bool(m.reached), (float(m.dist), int(m.steps))
    assert not bool(m.hit)
    assert not bool(m.oob)
    assert float(m.dist) <= SPEC.tol + 1e-9
    # done-rows freeze: steps strictly below budget, state frozen at goal
    assert int(m.steps) < 120


def test_respects_control_and_state_bounds():
    ctrl, params, start, goal = _setup()
    st = init_loop_state(jax.random.PRNGKey(1), ctrl, start, goal)
    st = st._replace(obst=_parked_obstacles(SPEC, jnp.float64))
    rollout = jax.jit(make_rollout(ctrl, goal, params, max_iter=120,
                                   random_move=False, collect=True))
    fin, (xs, _, _) = rollout(st)
    xs = np.asarray(xs)
    steps = int(metrics_of(fin).steps)
    dt = SPEC.dt
    # v' = u_a exactly, so finite differences recover the applied controls
    dv = np.diff(np.concatenate([[np.asarray(st.x0)[3]], xs[:steps, 3]])) / dt
    dom = np.diff(np.concatenate([[np.asarray(st.x0)[4]], xs[:steps, 4]])) / dt
    assert np.max(np.abs(dv)) <= SPEC.c_max + 1e-6
    assert np.max(np.abs(dom)) <= SPEC.c_max + 1e-6
    # state box (robot_ocp_problem.py:92-94): position within +-7, |v| <= 10
    assert np.max(np.abs(xs[:steps, :2])) <= 7.0 + 1e-6
    assert np.max(np.abs(xs[:steps, 3])) <= SPEC.v_max_robot + 1e-6


def test_avoids_moving_obstacles_most_seeds():
    # the bundled-baseline config (TF=2, N=20; BASELINE.md rows 4-7)
    spec = WorldSpec(tf=2.0, n_solv=20, qp_iter=20)
    opts = SolverOptions(qp_iter=20, integrator="rk4")
    ctrl = make_rti_controller(spec, opts, dtype=jnp.float64)
    params = default_cost_params(spec, dtype=jnp.float64)
    start, goal = robot_start_goal(spec)
    rollout = jax.jit(make_rollout(ctrl, goal, params, max_iter=350))
    reached, hits = 0, 0
    # seeds 1-3: seed 0 parks an obstacle on the goal for this PRNG stream
    # (a legitimate non-reach also present in the reference data's
    # steps=400 rows)
    for seed in [1, 2, 3]:
        st = init_loop_state(jax.random.PRNGKey(seed), ctrl, start, goal,
                             "RANDOM")
        m = metrics_of(rollout(st))
        reached += int(bool(m.reached))
        hits += int(bool(m.hit))
    # quality bar from the reference Monte-Carlo data (BASELINE.md): ~90%
    # goal-reached, ~16% collision over 100 seeds; with 3 seeds demand
    # at least 2 reached and at most 1 collision.
    assert reached >= 2, (reached, hits)
    assert hits <= 1


def test_batched_rollout_matches_single():
    ctrl, params, start, goal = _setup()
    B = 3
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    states = [init_loop_state(k, ctrl, start, goal, "RANDOM") for k in keys]
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    rollout = make_rollout(ctrl, goal, params, max_iter=40)
    out_b = jax.jit(jax.vmap(rollout))(batched)
    for i in range(B):
        out_s = jax.jit(rollout)(states[i])
        mb = metrics_of(jax.tree.map(lambda a: a[i], out_b))
        ms = metrics_of(out_s)
        np.testing.assert_allclose(float(mb.min_margin), float(ms.min_margin),
                                   atol=1e-8)
        np.testing.assert_allclose(float(mb.dist), float(ms.dist), atol=1e-8)
        assert int(mb.steps) == int(ms.steps)


def test_batched_tick_matches_vmapped_tick():
    from doa_mpc_tpu.sim.closed_loop import make_batched_tick
    ctrl, params, start, goal = _setup()
    B = 4
    st = init_loop_state(jax.random.PRNGKey(11), ctrl, start, goal, "RANDOM",
                         batch_shape=(B,))
    t_v = jax.jit(jax.vmap(make_tick(ctrl, goal, params)))
    t_b = jax.jit(make_batched_tick(ctrl, goal, params))
    sv, sb = st, st
    for _ in range(3):
        sv = t_v(sv)
        sb = t_b(sb)
    for a, b in zip(jax.tree.leaves(sv), jax.tree.leaves(sb)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-8)


def test_tick_freezes_done_rows():
    ctrl, params, start, goal = _setup()
    st = init_loop_state(jax.random.PRNGKey(2), ctrl, start, goal)
    st = st._replace(done=jnp.asarray(True))
    tick = jax.jit(make_tick(ctrl, goal, params))
    st2 = tick(st)
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(st2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_irk_integrator_closed_loop():
    # the reference's solver config uses IRK (robot_ocp_problem.py:129);
    # the implicit path must drive the loop to the goal too
    opts = SolverOptions(qp_iter=15, integrator="irk")
    ctrl = make_rti_controller(SPEC, opts, dtype=jnp.float64)
    params = default_cost_params(SPEC, dtype=jnp.float64)
    start, goal = robot_start_goal(SPEC)
    st = init_loop_state(jax.random.PRNGKey(0), ctrl, start, goal)
    st = st._replace(obst=_parked_obstacles(SPEC, jnp.float64))
    rollout = jax.jit(make_rollout(ctrl, goal, params, max_iter=120,
                                   random_move=False))
    m = metrics_of(rollout(st))
    assert bool(m.reached) and not bool(m.hit)


def test_f32_loop_runs_and_reaches():
    # production dtype: the same parked-obstacle scenario must still reach
    ctrl, params, start, goal = _setup(dtype=jnp.float32)
    st = init_loop_state(jax.random.PRNGKey(0), ctrl, start, goal)
    st = st._replace(obst=_parked_obstacles(SPEC, jnp.float32))
    rollout = jax.jit(make_rollout(ctrl, goal, params, max_iter=120,
                                   random_move=False))
    m = metrics_of(rollout(st))
    assert bool(m.reached)
    assert not bool(m.hit)


def test_status4_reset_fires_and_brakes():
    """The acados status-4 analogue (robot_ocp_problem.py:203-205): with
    impossible convergence tolerances every tick "fails", so the warm start
    must reset to the stationary guess and (compat_brake_bug) the plant
    velocity must be zeroed via the reference's x_guess aliasing bug
    (:301-302) before integration."""
    opts = SolverOptions(qp_iter=15, integrator="rk4",
                         init_guess_when_error=True,
                         fail_mu_tol=0.0, fail_stat_tol=0.0)  # always fail
    ctrl = make_rti_controller(SPEC, opts, dtype=jnp.float64)
    params = default_cost_params(SPEC, dtype=jnp.float64)
    start, goal = robot_start_goal(SPEC)
    st = init_loop_state(jax.random.PRNGKey(0), ctrl, start, goal)
    st = st._replace(obst=_parked_obstacles(SPEC, jnp.float64))
    tick = jax.jit(make_tick(ctrl, goal, params, random_move=False))
    st2 = tick(st)
    assert int(st2.resets) == 1
    # warm start was reset to the stationary guess at the PRE-integration
    # braked state (the reference resets before integrating, :203-207; the
    # subsequent warm shift of a constant trajectory is itself)
    np.testing.assert_allclose(np.asarray(st2.rti.x_traj),
                               np.tile(np.asarray(st.x0.at[3:].set(0.0)),
                                       (SPEC.n_solv + 1, 1)))
    # the brake acted before integration: the position moved less than an
    # unbraked start (v0=0 here so x0 change is second-order small)
    assert float(jnp.linalg.norm(st2.x0[:2] - st.x0[:2])) < 0.1
    st3 = tick(st2)
    assert int(st3.resets) == 2


def test_status4_disabled_by_default_and_never_fires_when_converged():
    ctrl, params, start, goal = _setup()
    # generous tolerances: the warm-started QP converges easily at iters=15
    opts = SolverOptions(qp_iter=15, integrator="rk4",
                         init_guess_when_error=True,
                         fail_mu_tol=1e3, fail_stat_tol=1e3)
    ctrl2 = make_rti_controller(SPEC, opts, dtype=jnp.float64)
    st = init_loop_state(jax.random.PRNGKey(0), ctrl2, start, goal)
    st = st._replace(obst=_parked_obstacles(SPEC, jnp.float64))
    rollout = jax.jit(make_rollout(ctrl2, goal, params, max_iter=120,
                                   random_move=False))
    fin = rollout(st)
    assert int(fin.resets) == 0
    assert bool(metrics_of(fin).reached)


def test_interpolate_init_guess_reproduces_reference_bugs():
    """The interpolate_init variant (robot_ocp_problem.py:293-300, commented
    code used by the two bundled interpolate baseline runs) has two bugs the
    compat path must reproduce: x never interpolates (x0 + i/N*(x0-x0)) and
    psi = atan2(dy, 0) = +-pi/2."""
    opts = SolverOptions(qp_iter=15, integrator="rk4",
                         init_guess="interpolate")
    ctrl = make_rti_controller(SPEC, opts, dtype=jnp.float64)
    x0 = jnp.array([-7.0, -7.0, 0.3, 1.0, 0.5], jnp.float64)
    goal = jnp.array([7.0, 7.0], jnp.float64)
    g = ctrl.initial_guess(x0, goal)
    n = SPEC.n_solv
    np.testing.assert_allclose(np.asarray(g.x_traj[:, 0]), -7.0)  # x frozen
    np.testing.assert_allclose(np.asarray(g.x_traj[:, 1]),
                               -7.0 + np.arange(n + 1) / n * 14.0)
    np.testing.assert_allclose(np.asarray(g.x_traj[:, 2]), np.pi / 2)
    np.testing.assert_allclose(np.asarray(g.x_traj[:, 3:]), 0.0)
    np.testing.assert_allclose(np.asarray(g.u_traj), 0.0)


def test_slack_scale_dt_option():
    """The slack_scale_dt ablation axis (round-5 forensics): with it off,
    path-stage slack penalties are the raw reference numbers — 1/dt times
    the dt-scaled default — while the terminal stage (alpha_N = 0) and
    every other QP field are unchanged."""
    import dataclasses

    from doa_mpc_tpu.config import SolverOptions, WorldSpec, default_cost_params
    from doa_mpc_tpu.sim.closed_loop import init_loop_state
    from doa_mpc_tpu.sim.obstacles import predict_trajectory, robot_start_goal
    from doa_mpc_tpu.solver.sqp_rti import make_rti_controller

    spec = WorldSpec(tf=2.0, n_solv=20, qp_iter=10)
    params = default_cost_params(spec, dtype=jnp.float64)
    start, goal = robot_start_goal(spec)
    qps = {}
    for flag in (True, False):
        opts = SolverOptions(qp_iter=10, integrator="rk4",
                             slack_scale_dt=flag)
        ctrl = make_rti_controller(spec, opts, dtype=jnp.float64)
        st = init_loop_state(jax.random.PRNGKey(3), ctrl,
                             jnp.asarray(start, jnp.float64), goal, "RANDOM")
        pred = predict_trajectory(st.obst, spec, spec.n_solv)
        qps[flag] = ctrl.build_qp(st.rti, st.x0, goal, pred, params)

    scaled, raw = qps[True], qps[False]
    dt = spec.dt
    np.testing.assert_allclose(np.asarray(raw.zl[:-1]),
                               np.asarray(scaled.zl[:-1]) / dt, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(raw.Zl[:-1]),
                               np.asarray(scaled.Zl[:-1]) / dt, rtol=1e-12)
    assert float(jnp.max(jnp.abs(raw.zl[-1]))) == 0.0    # alpha_N = 0
    for field in ("Q", "q", "R", "r", "A", "B", "c", "lb_x", "ub_x",
                  "lb_u", "ub_u", "C", "hval"):
        np.testing.assert_array_equal(np.asarray(getattr(raw, field)),
                                      np.asarray(getattr(scaled, field)))
