"""Closed-loop RTI simulation as a jitted, batched ``lax.scan``.

Batched JAX rewrite of ``RobotOcpProblem.step`` (the reference's hot loop,
``/root/reference/src/simulation/robot_ocp_problem.py:168-277``): the Python
while-loop with per-stage solver chatter becomes one scan whose carried state
is a pytree of device arrays; per-scenario early exit ("reached goal ->
break", :247-250) becomes a ``done`` mask that freezes finished rows while
the rest of the batch keeps solving.

Per tick, mirroring :184-258 in order:

1. forecast obstacle trajectories (noise-free bounce, :154-160),
2. recompute the distance-scaled slack weights (:145-152, via build_qp),
3. RTI solve from the warm-started guess and take u0 (:195-198),
4. integrate the plant one dt with the same IRK scheme (:207-212),
5. step the obstacle world with motion noise (:217-218),
6. update min-margin / collision / out-of-bounds / goal metrics (:213-250),
7. shift the warm start (:253-258).

Note: the reference continues simulating after a collision — only reaching
the goal (or the tick budget) ends a run; ``hit`` is judged afterwards from
``min_margin <= 0`` (:277). Reproduced exactly.

The acados status-4 reset path (:203-205) — armed in EVERY bundled baseline
run (``test_data/*spec.json`` has ``"init_guess": true`` throughout) — is
reproduced behind ``SolverOptions.init_guess_when_error``: a row whose
interior point did not converge within its fixed ``qp_iter`` budget (the
analogue of HPIPM hitting ``qp_solver_iter_max``, which acados maps to NLP
status 4) takes the reference's reset branch as a masked select: the warm
start resets to the stationary guess AND, because ``set_initial_guess``
aliases ``self.x0`` (``x_guess = self.x0; x_guess[3:] = 0``,
robot_ocp_problem.py:301-302), the PLANT's velocity is zeroed before this
tick's integration — an accidental emergency brake. The failed solve's u0
is still applied (the reference reads u before resetting, :198 vs :203).

Round-5 calibration finding (results/parity_r5/, the seed-matched ablation
matrix): the analogue's "not converged to (fail_mu, fail_stat)" criterion
fires ~9-49x per run at the bundled budgets — while the reference's HPIPM
evidently almost never returned status 4 there — and those uncalibrated
mid-traffic brakes were the ENTIRE round-3/4 collision excess (+8.1 pp ->
-0.3 pp when disabled) plus most of the trip-time and min-margin gaps.
Keep ``init_guess_when_error=False`` (the default) unless specifically
studying the failure path; arming it requires a fail criterion calibrated
to the actual QP-failure rate of the solver being mimicked.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from doa_mpc_tpu.config import CostParams
from doa_mpc_tpu.sim.obstacles import (
    ObstacleState, generate_obstacles, obstacle_step, predict_trajectory,
)
from doa_mpc_tpu.solver.sqp_rti import RtiController, RtiState


class LoopState(NamedTuple):
    """Carried per-scenario closed-loop state (batched by vmap)."""

    x0: jnp.ndarray          # (nx,) current plant state
    rti: RtiState            # warm-started solver trajectories
    obst: ObstacleState      # obstacle world
    key: jnp.ndarray         # per-scenario PRNG key
    done: jnp.ndarray        # () bool — goal reached, row frozen
    reached: jnp.ndarray     # () bool
    oob: jnp.ndarray         # () bool — ever left the 16x16 grid (:213-214)
    min_margin: jnp.ndarray  # () running min margin to any obstacle (:222-228)
    dist: jnp.ndarray        # () last distance to goal (:247)
    steps: jnp.ndarray       # () int32 — reference's returned i (:277)
    resets: jnp.ndarray      # () int32 — status-4 analogue firings (:203-205)


class LoopMetrics(NamedTuple):
    """The 6-column result row written by experiments.py:36
    (robot_ocp_problem.py:277 minus the state)."""

    hit: jnp.ndarray
    reached: jnp.ndarray
    min_margin: jnp.ndarray
    dist: jnp.ndarray
    steps: jnp.ndarray
    oob: jnp.ndarray


def metrics_of(state: LoopState) -> LoopMetrics:
    return LoopMetrics(
        hit=(state.min_margin <= 0.0),
        reached=state.reached,
        min_margin=state.min_margin,
        dist=state.dist,
        steps=state.steps,
        oob=state.oob,
    )


def init_loop_state(key, ctrl: RtiController, x_init, goal,
                    scenario: str = "RANDOM", batch_shape=(),
                    obst: ObstacleState | None = None) -> LoopState:
    """Fresh experiment (set_up_new_experiment, robot_ocp_problem.py:309):
    new obstacles, cold-started solver, cleared metrics.

    Pass ``obst`` to pin the obstacle world instead of sampling it — the
    MT19937 compat mode supplies the reference's exact seeded worlds here
    (``sim/compat_rng.mt_experiment_batch``)."""
    spec = ctrl.spec
    kobs, kloop = jax.random.split(key)
    x_init = jnp.asarray(x_init)        # callers may pass host numpy
    dtype = x_init.dtype
    if obst is None:
        obst = generate_obstacles(kobs, spec, scenario, batch_shape,
                                  dtype=dtype)
    else:
        obst = ObstacleState(pos=jnp.asarray(obst.pos, dtype),
                             vel=jnp.asarray(obst.vel, dtype))

    def one(x):
        return ctrl.initial_guess(x, jnp.asarray(goal, x.dtype))

    if batch_shape:
        x_init = jnp.broadcast_to(x_init, tuple(batch_shape) + x_init.shape[-1:])
        rti = jax.vmap(one)(x_init.reshape((-1, x_init.shape[-1])))
        rti = jax.tree.map(
            lambda a: a.reshape(tuple(batch_shape) + a.shape[1:]), rti)
        import math
        keys = jax.random.split(kloop, math.prod(batch_shape))
        keys = keys.reshape(tuple(batch_shape) + keys.shape[1:])
    else:
        rti = one(x_init)
        keys = kloop

    zeros = jnp.zeros(batch_shape, dtype)
    dist0 = jnp.linalg.norm(
        x_init[..., :2] - goal, axis=-1) * jnp.ones(batch_shape, dtype)
    return LoopState(
        x0=x_init, rti=rti, obst=obst, key=keys,
        done=jnp.zeros(batch_shape, bool),
        reached=jnp.zeros(batch_shape, bool),
        oob=jnp.zeros(batch_shape, bool),
        min_margin=jnp.full(batch_shape, jnp.inf, dtype),
        dist=dist0,
        steps=jnp.zeros(batch_shape, jnp.int32),
        resets=jnp.zeros(batch_shape, jnp.int32),
    )


def _full_precision(fn):
    """Trace ``fn`` with full-f32 matmuls. An accelerator may run a default
    f32 dot with reduced-precision passes (TF32 on a GPU); the tick's
    products are 5x5 and 20x20 blocks that gain nothing from them, and the
    interior point and the IRK block LU need the digits."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def make_parametric_tick(ctrl: RtiController, random_move: bool = True,
                         return_pred: bool = False):
    """Single-scenario tick taking (state, goal, params) as traced inputs.

    ``goal`` being an argument (not a closure) is the ``set_subgoal``
    interface (robot_ocp_problem.py:279-284): the RL layer retargets the
    controller tick-by-tick. ``params`` as an argument enables batched
    cost-weight sweeps / RL-tuned weights.

    With ``return_pred`` the tick also returns the solver's predicted state
    horizon for this tick (pre-shift, stages 0..N) — what the reference
    records for visualization via ``solver.get(i, 'x')`` right after the
    solve (robot_ocp_problem.py:237-241, ``show_pred``).
    """
    spec, opts = ctrl.spec, ctrl.options
    n = spec.n_solv

    @_full_precision
    def tick(st: LoopState, goal, params: CostParams):
        # 1. obstacle forecast for the horizon (parameterize_model, :154-166)
        pred = predict_trajectory(
            st.obst, spec, n, compat_pred_bug=opts.compat_pred_bug)
        # pred: (N+1, M, 2)

        # 2-3. one real-time iteration from the warm start
        rti_new, u0, sol = ctrl.rti_step(st.rti, st.x0, goal, pred, params)

        # status-4 analogue (robot_ocp_problem.py:203-205; docstring above).
        # The failed u0 is applied regardless (reference reads u first).
        x0_eff = st.x0
        resets = st.resets
        if opts.init_guess_when_error:
            fail = ~((sol.mu < opts.fail_mu_tol)
                     & (sol.stat_res < opts.fail_stat_tol))
            if opts.compat_brake_bug and opts.init_guess != "interpolate":
                x0_eff = jnp.where(fail, st.x0.at[3:].set(0.0), st.x0)
            reset = ctrl.initial_guess(x0_eff, goal)
            rti_new = jax.tree.map(
                lambda a, b: jnp.where(fail, a, b), reset, rti_new)
            resets = st.resets + jnp.int32(fail)

        # 4. plant step (ocp_integrator, :207-212)
        x_new = ctrl.integrate(x0_eff, u0)

        # 5. obstacle world advances with motion noise (:217-218)
        key, sub = jax.random.split(st.key)
        obst_new = obstacle_step(sub, st.obst, spec, random_move=random_move)

        # 6. metrics (:213-250)
        oob = (st.oob | (jnp.abs(x_new[0]) > spec.x_max)
               | (jnp.abs(x_new[1]) > spec.y_max))
        d = x_new[None, :2] - obst_new.pos
        margin = jnp.min(jnp.linalg.norm(d, axis=-1)
                         - (spec.r_obst + spec.r_robot))
        min_margin = jnp.minimum(st.min_margin, margin)
        dist = jnp.linalg.norm(x_new[:2] - goal)
        reached = dist <= spec.tol
        steps = st.steps + jnp.int32(~reached)

        # 7. warm-start shift (:253-258)
        rti_shifted = ctrl.shift(rti_new)

        new = LoopState(
            x0=x_new, rti=rti_shifted, obst=obst_new, key=key,
            done=st.done | reached, reached=st.reached | reached,
            oob=oob, min_margin=min_margin, dist=dist, steps=steps,
            resets=resets)

        # freeze finished rows (the reference's `break`, :249-250)
        frozen = jax.tree.map(
            lambda old, upd: jnp.where(_mask(st.done, upd.ndim), old, upd),
            st, new)
        if return_pred:
            return frozen, rti_new.x_traj
        return frozen

    return tick


def make_tick(ctrl: RtiController, goal, params: CostParams,
              random_move: bool = True, return_pred: bool = False):
    """Fixed-goal tick (the plain closed loop; vmap for the batch)."""
    ptick = make_parametric_tick(ctrl, random_move=random_move,
                                 return_pred=return_pred)

    def tick(st: LoopState):
        return ptick(st, goal, params)

    return tick


def make_batched_tick(ctrl: RtiController, goal, params: CostParams,
                      random_move: bool = True):
    """Natively-batched control tick.

    Unlike ``vmap(make_tick(...))`` this calls the interior-point solver
    (``ops/ip_qp.py``) on the whole scenario batch at once.
    """
    from doa_mpc_tpu.ops.ip_qp import solve_ocp_qp

    spec, opts = ctrl.spec, ctrl.options
    n = spec.n_solv

    @_full_precision
    def tick(st: LoopState, noise=None) -> LoopState:
        # ``noise``: optional (B, M, 2) precomputed standard-normal draw for
        # this tick's obstacle noise (MT19937 compat mode, sim/compat_rng.py)
        # 1. obstacle forecast (vectorized over the batch; scan over steps)
        pred = predict_trajectory(
            st.obst, spec, n, compat_pred_bug=opts.compat_pred_bug)
        pred = jnp.moveaxis(pred, 0, 1)           # (B, N+1, M, 2)

        # 2. Gauss-Newton linearization + QP assembly per scenario
        qp = jax.vmap(
            lambda rti, x0, p: ctrl.build_qp(rti, x0, goal, p, params)
        )(st.rti, st.x0, pred)

        # 3. one batched interior-point solve
        sol = solve_ocp_qp(qp, iters=opts.qp_iter, tau=opts.ip_tau)
        rti_new = RtiState(x_traj=st.rti.x_traj + sol.dx,
                           u_traj=st.rti.u_traj + sol.du)
        u0 = rti_new.u_traj[:, 0]

        # status-4 analogue (robot_ocp_problem.py:203-205; module docstring):
        # rows whose IP did not converge within qp_iter reset their warm
        # start and (compat_brake_bug) brake the plant; failed u0 still
        # applies this tick.
        x0_eff = st.x0
        resets = st.resets
        if opts.init_guess_when_error:
            fail = ~((sol.mu < opts.fail_mu_tol)
                     & (sol.stat_res < opts.fail_stat_tol))
            if opts.compat_brake_bug and opts.init_guess != "interpolate":
                braked = st.x0.at[:, 3:].set(0.0)
                x0_eff = jnp.where(fail[:, None], braked, st.x0)
            reset = jax.vmap(lambda x: ctrl.initial_guess(x, goal))(x0_eff)
            rti_new = jax.tree.map(
                lambda a, b: jnp.where(
                    jnp.reshape(fail, fail.shape + (1,) * (b.ndim - 1)),
                    a, b),
                reset, rti_new)
            resets = st.resets + jnp.int32(fail)

        # 4. plant step
        x_new = ctrl.integrate(x0_eff, u0)

        # 5. noisy obstacle world step (per-row keys, or the compat stream)
        keys = jax.vmap(jax.random.split)(st.key)
        key, sub = keys[:, 0], keys[:, 1]
        if noise is None:
            obst_new = jax.vmap(
                lambda k, p, v: obstacle_step(k, ObstacleState(p, v), spec,
                                              random_move=random_move)
            )(sub, st.obst.pos, st.obst.vel)
        else:
            obst_new = obstacle_step(sub, st.obst, spec,
                                     random_move=random_move, noise=noise)

        # 6. metrics (batched forms of robot_ocp_problem.py:213-250)
        oob = (st.oob | (jnp.abs(x_new[:, 0]) > spec.x_max)
               | (jnp.abs(x_new[:, 1]) > spec.y_max))
        d = x_new[:, None, :2] - obst_new.pos
        margin = jnp.min(jnp.linalg.norm(d, axis=-1)
                         - (spec.r_obst + spec.r_robot), axis=-1)
        min_margin = jnp.minimum(st.min_margin, margin)
        dist = jnp.linalg.norm(x_new[:, :2] - goal, axis=-1)
        reached = dist <= spec.tol
        steps = st.steps + jnp.int32(~reached)

        # 7. warm-start shift
        rti_shifted = ctrl.shift(rti_new)

        new = LoopState(
            x0=x_new, rti=rti_shifted, obst=obst_new, key=key,
            done=st.done | reached, reached=st.reached | reached,
            oob=oob, min_margin=min_margin, dist=dist, steps=steps,
            resets=resets)

        return jax.tree.map(
            lambda old, upd: jnp.where(
                jnp.reshape(st.done, st.done.shape + (1,) * (upd.ndim - 1)),
                old, upd),
            st, new)

    return tick


def make_batched_rollout(ctrl: RtiController, goal, params: CostParams,
                         max_iter: int = 400, random_move: bool = True,
                         collect: bool = False,
                         use_noise_traj: bool = False):
    """Scan the batched tick ``max_iter`` times.

    With ``use_noise_traj`` the rollout takes a second argument — a
    ``(max_iter, B, M, 2)`` precomputed obstacle-noise stream (the MT19937
    compat mode, ``sim/compat_rng.py``) — consumed one slice per tick."""
    tick = make_batched_tick(ctrl, goal, params, random_move=random_move)

    def rollout(st: LoopState, noise_traj=None):
        def body(s, xs):
            s2 = tick(s, noise=xs)
            out = (s2.x0, s2.obst.pos) if collect else None
            return s2, out

        final, traj = jax.lax.scan(body, st, noise_traj, length=max_iter)
        if collect:
            return final, traj
        return final

    if use_noise_traj:
        return rollout
    return lambda st: rollout(st, None)


def _mask(done, ndim):
    """Broadcast the scalar done flag over an array of rank ndim."""
    return jnp.reshape(done, (1,) * ndim) if ndim else done


def make_rollout(ctrl: RtiController, goal, params: CostParams,
                 max_iter: int = 400, random_move: bool = True,
                 collect: bool = False):
    """Scan ``max_iter`` ticks (the reference's step(400),
    experiments.py:36). With ``collect`` the per-tick robot position,
    obstacle positions, AND the solver's predicted state horizon are stacked
    — the reference's ``show_pred`` capture (robot_ocp_problem.py:237-241)
    — as a (x0, obst_pos, pred_x) tuple for golden tests and
    visualization (``utils/viz.py`` ``pred_traj``)."""
    tick = make_tick(ctrl, goal, params, random_move=random_move,
                     return_pred=collect)

    def rollout(st: LoopState):
        def body(s, _):
            if collect:
                s2, pred_x = tick(s)
                return s2, (s2.x0, s2.obst.pos, pred_x)
            return tick(s), None

        final, traj = jax.lax.scan(body, st, None, length=max_iter)
        if collect:
            return final, traj
        return final

    return rollout
