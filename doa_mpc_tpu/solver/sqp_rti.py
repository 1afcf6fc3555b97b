"""SQP real-time-iteration (RTI) controller.

The batched JAX equivalent of the acados solver configuration built at
``/root/reference/src/simulation/robot_ocp_problem.py:54-143``: per control
tick, ONE Gauss-Newton linearization around the warm-started trajectory
guess, followed by one structured QP solve (``ops/ip_qp.py``), followed by a
full step — exactly acados' ``nlp_solver_type='SQP_RTI'``.

Pieces mirrored, with their reference anchors:

- LINEAR_LS cost selecting y = (x, y, v, omega, u_a, u_alpha) with
  W = blkdiag(2*I4, 0.15*I2), terminal W_e = 5*I4 (robot_ocp_problem.py:60-84)
  — here materialized directly as diagonal Gauss-Newton stage Hessians.
- Levenberg-Marquardt regularization 2.0 added to every stage Hessian
  (robot_ocp_problem.py:128; acados adds lm*I to the GN Hessian).
- acados scales path stage costs by the discretization step dt
  (``cost_scaling`` defaults to the time steps, terminal 1.0); controlled
  here by ``SolverOptions.cost_scale_dt``.
- Box constraints: |x|,|y| <= 7, |v|,|omega| <= 10 on intermediate stages,
  |u| <= 8 everywhere (robot_ocp_problem.py:87-97). Stage 0 state is pinned
  to x0 (the ubx/lbx <- x0 trick at robot_ocp_problem.py:191-192).
- Soft obstacle constraints with the distance-scaled, stage-discounted
  L1+L2 slack weights alpha_i = 1e4*(||sel(x0)-[goal,0,0]||^2 + 50)*(N-i)/N
  (robot_ocp_problem.py:145-152); terminal alpha_N = 0.
- Warm-start shift: trajectories shift one stage left, the last control is
  zeroed (robot_ocp_problem.py:253-258).
- Cold-start guess: all stages at x0 with v, omega zeroed, u = 0
  (robot_ocp_problem.py:291-307 ``set_initial_guess``).

All functions are single-scenario; batch via ``vmap`` (the experiment
harness shards the batch over the device mesh).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from doa_mpc_tpu.config import CostParams, SolverOptions, WorldSpec
from doa_mpc_tpu.models.unicycle import obstacle_h, obstacle_h_jac
from doa_mpc_tpu.ops.integrators import make_integrator
from doa_mpc_tpu.ops.ocp_qp import BIG_BOUND, IDXBX, OcpQp
from doa_mpc_tpu.ops.ip_qp import IpSolution, solve_ocp_qp


def _scatter_idxbx(vals, nx, dtype):
    """Place vals[j] at state index IDXBX[j], zeros elsewhere — statically
    unrolled (no scatter op)."""
    pos = {s: j for j, s in enumerate(IDXBX)}
    return jnp.stack([vals[pos[i]] if i in pos else jnp.zeros((), dtype)
                      for i in range(nx)])


class RtiState(NamedTuple):
    """Warm-started solver state carried across control ticks.

    The acados analogue is the solver-internal trajectory accessed via
    ``ocp_solver.set(i, 'x'|'u', ...)`` (robot_ocp_problem.py:253-258).
    """

    x_traj: jnp.ndarray  # (N+1, nx) linearization guess
    u_traj: jnp.ndarray  # (N, nu)


@dataclasses.dataclass(frozen=True)
class RtiController:
    """Bound methods for one RTI configuration (spec/options static)."""

    spec: WorldSpec
    options: SolverOptions
    integrate: Callable          # Phi(x, u, dt)
    lin: Callable                # (x, u) -> (Phi, A, B) batched over stages

    def cold_start(self, x0: jnp.ndarray) -> RtiState:
        """Initial guess per ``set_initial_guess`` (robot_ocp_problem.py:291):
        every stage at x0 with v, omega zeroed; controls zero."""
        n = self.spec.n_solv
        x0 = jnp.asarray(x0)            # callers may pass host numpy
        xg = x0.at[3:].set(0.0)
        return RtiState(
            x_traj=jnp.tile(xg[None], (n + 1, 1)),
            u_traj=jnp.zeros((n, self.spec.nu), x0.dtype),
        )

    def initial_guess(self, x0: jnp.ndarray, goal: jnp.ndarray) -> RtiState:
        """``set_initial_guess`` (robot_ocp_problem.py:286-306) with the
        strategy chosen by ``options.init_guess``.

        "current" is the reference's active code path (:301-306): every stage
        at x0 with v, omega zeroed. "interpolate" is the commented
        straight-line variant (:293-300) used by the two bundled
        ``interpolate_init`` baseline runs, with its bugs reproduced
        faithfully: x never interpolates (``x0[0] + i/N*(x0[0]-x0[0])``),
        only y walks to the subgoal, and the heading guess is
        ``atan2(goal_y - y0, goal_x - goal_x)`` = atan2(dy, 0) = +-pi/2.
        """
        if self.options.init_guess != "interpolate":
            return self.cold_start(x0)
        n = self.spec.n_solv
        dtype = x0.dtype
        frac = jnp.arange(n + 1, dtype=dtype) / n
        y = x0[1] + frac * (goal[1] - x0[1])
        psi = jnp.arctan2(goal[1] - x0[1], jnp.zeros((), dtype))
        x_traj = jnp.stack([
            jnp.full((n + 1,), x0[0], dtype), y,
            jnp.full((n + 1,), psi, dtype),
            jnp.zeros((n + 1,), dtype), jnp.zeros((n + 1,), dtype)], axis=-1)
        return RtiState(x_traj=x_traj,
                        u_traj=jnp.zeros((n, self.spec.nu), dtype))

    def shift(self, state: RtiState) -> RtiState:
        """Warm-start shift (robot_ocp_problem.py:253-258): move stages one
        left, duplicate terminal state, zero the last control. Batch-generic
        (stage axis is -2)."""
        x = jnp.concatenate(
            [state.x_traj[..., 1:, :], state.x_traj[..., -1:, :]], axis=-2)
        u = jnp.concatenate(
            [state.u_traj[..., 1:, :],
             jnp.zeros_like(state.u_traj[..., :1, :])], axis=-2)
        return RtiState(x, u)

    def build_qp(self, state: RtiState, x0, goal, obst_traj,
                 params: CostParams) -> OcpQp:
        """Gauss-Newton linearization around the guess -> OCP QP.

        ``obst_traj`` is the (N+1, M, 2) obstacle position forecast — the
        per-stage parameter vector of robot_model.py:36 set at
        robot_ocp_problem.py:154-166.
        """
        spec, opts = self.spec, self.options
        n, nx, nu = spec.n_solv, spec.nx, spec.nu
        dt = spec.tf / spec.n_solv
        dtype = state.x_traj.dtype
        xg, ug = state.x_traj, state.u_traj

        # --- dynamics sensitivities (CasADi codegen -> jacfwd) ----------
        phi, A, B = self.lin(xg[:-1], ug)
        c = phi - xg[1:]

        # --- LINEAR_LS Gauss-Newton cost --------------------------------
        sc = jnp.full((n + 1,), dt if opts.cost_scale_dt else 1.0, dtype)
        sc = sc.at[-1].set(1.0)
        # cost selects (x, y, v, omega). IDXBX is STATIC, so the select is
        # unrolled into stack ops.
        w_q = _scatter_idxbx(params.q_diag, nx, dtype)
        w_qe = _scatter_idxbx(params.qe_diag, nx, dtype)
        yref = jnp.zeros((nx,), dtype).at[0].set(goal[0]).at[1].set(goal[1])

        # Levenberg-Marquardt enters INSIDE the dt-scaled stage cost, the
        # way acados applies it (the LM term is part of the cost-module
        # Hessian, which cost_scaling multiplies wholesale): path stages get
        # lm*dt, the terminal stage lm*1. Adding raw lm=2.0 on top of the
        # dt-scaled Hessian (the round-1/2 behavior, kept under
        # lm_scale_dt=False) over-damps du by ~10x and makes closed-loop
        # trips ~40% slower than the reference's bundled runs (measured:
        # open-road trip 59 ticks raw vs 49 scaled == converged-SQP pace ==
        # the reference CSVs' fastest runs).
        lm = params.lm_reg
        lm_sc = sc if opts.lm_scale_dt else jnp.ones_like(sc)
        Q = (sc[:-1, None, None] * jnp.diag(w_q)[None]
             + (lm_sc[:-1, None, None] * lm)
             * jnp.eye(nx, dtype=dtype)[None]) * jnp.ones((n, 1, 1), dtype)
        Q_N = jnp.diag(w_qe) + lm * jnp.eye(nx, dtype=dtype)
        Q = jnp.concatenate([Q, Q_N[None]], axis=0)
        q = sc[:, None] * (jnp.concatenate([w_q[None] * jnp.ones((n, 1), dtype),
                                            w_qe[None]], axis=0)
                           * (xg - yref[None]))

        R = (sc[:-1, None, None] * jnp.diag(params.r_diag)[None]
             + (lm_sc[:-1, None, None] * lm)
             * jnp.eye(nu, dtype=dtype)[None]) * jnp.ones((n, 1, 1), dtype)
        r = sc[:-1, None] * params.r_diag[None] * ug
        S = jnp.zeros((n, nu, nx), dtype)

        # --- box constraints (relative to the guess) --------------------
        lb_u = -params.u_bound - ug
        ub_u = params.u_bound - ug
        nbx = len(IDXBX)
        lo = jnp.stack([-params.x_bound, -params.x_bound,
                        -params.v_bound, -params.v_bound])
        hi = -lo
        xg_sel = jnp.stack([xg[:, i] for i in IDXBX], axis=-1)
        lb_x = lo[None] - xg_sel
        ub_x = hi[None] - xg_sel
        big = jnp.full((1, nbx), BIG_BOUND, dtype)
        # acados applies lbx/ubx to stages 1..N-1 only; stage 0 is the x0
        # equality, the terminal stage has no box (robot_ocp_problem.py:87-97)
        lb_x = jnp.concatenate([-big, lb_x[1:-1], -big], axis=0)
        ub_x = jnp.concatenate([big, ub_x[1:-1], big], axis=0)

        # --- soft obstacle constraints ----------------------------------
        safe_sq = (spec.r_obst + spec.r_robot + spec.margin) ** 2
        hval = obstacle_h(xg, obst_traj, safe_sq)          # (N+1, M)
        C = obstacle_h_jac(xg, obst_traj)                  # (N+1, M, nx)

        # distance-scaled, stage-discounted slack weights
        # (robot_ocp_problem.py:145-152)
        selx0 = jnp.stack([x0[i] for i in IDXBX])
        goal4 = jnp.zeros((nbx,), dtype).at[0].set(goal[0]).at[1].set(goal[1])
        scale = params.slack_scale * (
            jnp.sum((selx0 - goal4) ** 2) + params.slack_offset)
        stage_idx = jnp.arange(n + 1, dtype=dtype)
        alpha = scale * (n - stage_idx) / n                # alpha_N = 0
        slack_sc = sc if opts.slack_scale_dt else jnp.ones_like(sc)
        zl = slack_sc[:, None] * alpha[:, None] * jnp.ones((1, spec.n_obst),
                                                           dtype)
        Zl = zl

        return OcpQp(A=A, B=B, c=c, dx0=x0 - xg[0], Q=Q, q=q, R=R, r=r, S=S,
                     lb_u=lb_u, ub_u=ub_u, lb_x=lb_x, ub_x=ub_x,
                     C=C, hval=hval, zl=zl, Zl=Zl)

    def rti_step(self, state: RtiState, x0, goal, obst_traj,
                 params: CostParams):
        """One real-time iteration: linearize -> QP -> full step.

        Returns (new_state, u0, diagnostics) where u0 is the control applied
        to the plant (ocp_solver.get(0, 'u'), robot_ocp_problem.py:198).
        """
        qp = self.build_qp(state, x0, goal, obst_traj, params)
        sol: IpSolution = solve_ocp_qp(
            qp, iters=self.options.qp_iter, tau=self.options.ip_tau,
            reg=self.options.ip_reg)
        new = RtiState(x_traj=state.x_traj + sol.dx,
                       u_traj=state.u_traj + sol.du)
        u0 = new.u_traj[0]
        return new, u0, sol


def make_rti_controller(spec: WorldSpec, options: SolverOptions | None = None,
                        dtype=jnp.float32) -> RtiController:
    options = options or SolverOptions(qp_iter=spec.qp_iter)
    integrate = make_integrator(options, dtype=dtype)
    dt = spec.tf / spec.n_solv

    def one_stage(x, u):
        phi = integrate(x, u, dt)
        return phi

    def lin(xs, us):
        """Stage-wise (Phi, dPhi/dx, dPhi/du) over (N, nx)/(N, nu) arrays."""
        def single(x, u):
            phi = one_stage(x, u)
            A = jax.jacfwd(one_stage, argnums=0)(x, u)
            B = jax.jacfwd(one_stage, argnums=1)(x, u)
            return phi, A, B
        return jax.vmap(single)(xs, us)

    return RtiController(spec=spec, options=options,
                         integrate=lambda x, u: one_stage(x, u), lin=lin)
