"""Configuration system.

The reference keeps its configuration as module-level constants in
``src/models/world_specification.py:1-48`` and *sweeps* them by rewriting that
source file in place (``src/simulation/run_multiple_experiments.py:8-21``).
Here configuration is data:

- :class:`WorldSpec` — *static* (shape-determining) configuration: horizon
  length, obstacle count, grid geometry. Hashable; passed to ``jit`` as a
  static argument. Changing it triggers recompilation (shapes change).
- :class:`CostParams` — *runtime* numeric parameters (cost weights, bounds,
  regularization) as a pytree of arrays, so weight sweeps / RL-tuned weights
  are just a batch axis, not a recompile.
- :class:`SolverOptions` — static solver knobs mirroring the acados options
  chosen at ``src/simulation/robot_ocp_problem.py:125-131``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class WorldSpec:
    """Static world geometry + problem sizes.

    Field values mirror the reference ``src/models/world_specification.py``:
    grid +-8 (:7-10), robot radius 0.2 / v_max 10 (:13-14), control bound 8
    (:22), 5 obstacles of radius 1 with v_max 2 and motion noise 0.1 (:25-31),
    safety margin 1.2 (:35), horizon TF=0.5 with N = int(TF*10) (:43-44),
    goal tolerance 0.15 (:45).
    """

    # grid world bounds (world_specification.py:6-10)
    x_min: float = -8.0
    x_max: float = 8.0
    y_min: float = -8.0
    y_max: float = 8.0

    # robot (world_specification.py:13-14)
    r_robot: float = 0.2
    v_max_robot: float = 10.0

    # control bounds (world_specification.py:22)
    c_max: float = 8.0

    # obstacles (world_specification.py:25-35)
    n_obst: int = 5
    r_obst: float = 1.0
    randomness: float = 0.1
    v_max_obst: float = 2.0
    margin: float = 1.2

    # horizon (world_specification.py:43-44)
    tf: float = 2.0
    n_solv: int = 20

    # goal tolerance (world_specification.py:45)
    tol: float = 0.15

    # QP interior-point iteration budget (world_specification.py:48;
    # reference default 50, bundled experiment data uses 25/50/100/150)
    qp_iter: int = 50

    # problem sizes (fixed by the unicycle model, robot_model.py:14-28)
    nx: int = 5
    nu: int = 2

    @property
    def dt(self) -> float:
        """Control/simulation tick: TF / N (world_specification.py:43-44)."""
        return self.tf / self.n_solv

    # robot start/goal placement bounds (world_specification.py:16-19)
    @property
    def robot_box(self) -> Tuple[float, float, float, float]:
        return (self.x_min + 2.0, self.x_max - 2.0, self.y_min + 2.0, self.y_max - 2.0)

    # obstacle placement bounds (world_specification.py:36-40):
    # Y_MIN_OBST = Y_MIN_ROBOT + R_MAX_OBST + 3*R_ROBOT, Y_MAX_OBST = -Y_MIN_ROBOT
    @property
    def obst_box(self) -> Tuple[float, float, float, float]:
        lo = (self.y_min + 2.0) + 1.0 + 3.0 * self.r_robot
        hi = -(self.y_min + 2.0)
        return (lo, hi, lo, hi)

    def replace(self, **kw) -> "WorldSpec":
        return dataclasses.replace(self, **kw)


def default_cost_params(spec: WorldSpec, dtype=jnp.float32) -> "CostParams":
    """Cost weights exactly as constructed in ``robot_ocp_problem.py:23-28,60-84``.

    The reference LINEAR_LS cost selects y = (x, y, v, omega, u_a, u_alpha):
    ``Vx`` picks states (0,1,3,4) (:61-63), ``Vu`` picks both controls (:64-65),
    W = blkdiag(2*I4, 0.15*I2) (:78-81), terminal W_e = 5*I4 over the same
    state selection (:70-73, 83).
    """
    # Host (numpy) arrays: tick factories close over these, and numpy
    # closures inline as HLO literals.
    import numpy as np
    return CostParams(
        q_diag=np.asarray([2.0, 2.0, 2.0, 2.0], dtype=dtype),
        r_diag=np.asarray([0.15, 0.15], dtype=dtype),
        qe_diag=np.asarray([5.0, 5.0, 5.0, 5.0], dtype=dtype),
        lm_reg=np.asarray(2.0, dtype=dtype),
        slack_scale=np.asarray(1e4, dtype=dtype),
        slack_offset=np.asarray(50.0, dtype=dtype),
        x_bound=np.asarray(7.0, dtype=dtype),
        v_bound=np.asarray(spec.v_max_robot, dtype=dtype),
        u_bound=np.asarray(spec.c_max, dtype=dtype),
    )


@dataclasses.dataclass
class CostParams:
    """Runtime cost/constraint parameters (a pytree; batchable for sweeps).

    ``slack_scale``/``slack_offset`` parameterize the distance-scaled,
    stage-discounted soft-constraint penalty of ``robot_ocp_problem.py:145-152``:
    ``alpha_i = slack_scale * (||sel(x0) - [goal,0,0]||^2 + slack_offset)
    * (N - i) / N`` with ``zl_i = Zl_i = alpha_i``.
    ``lm_reg`` is the Levenberg-Marquardt constant added to the Gauss-Newton
    Hessian (``robot_ocp_problem.py:128``, value 2.0).
    ``x_bound`` is the +-7 position box of ``robot_ocp_problem.py:92-94``.
    """

    q_diag: jnp.ndarray   # (4,)  weight on (x, y, v, omega)
    r_diag: jnp.ndarray   # (2,)  weight on (u_a, u_alpha)
    qe_diag: jnp.ndarray  # (4,)  terminal weight on (x, y, v, omega)
    lm_reg: jnp.ndarray   # ()    Levenberg-Marquardt Hessian regularization
    slack_scale: jnp.ndarray   # ()  1e4 in the reference
    slack_offset: jnp.ndarray  # ()  +50 in the reference
    x_bound: jnp.ndarray  # ()    |x|,|y| <= 7 box on stages 1..N-1
    v_bound: jnp.ndarray  # ()    |v|,|omega| <= V_MAX_ROBOT
    u_bound: jnp.ndarray  # ()    |u| <= C_MAX


import jax.tree_util as jtu

jtu.register_dataclass(
    CostParams,
    data_fields=[f.name for f in dataclasses.fields(CostParams)],
    meta_fields=[],
)


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Static solver configuration (mirrors ``robot_ocp_problem.py:125-131``).

    The reference picks SQP_RTI (one Gauss-Newton iteration per control tick),
    an IRK integrator, Levenberg-Marquardt 2.0 and PARTIAL_CONDENSING_HPIPM
    with ``qp_solver_iter_max = QP_ITER``. Here:

    - ``integrator``: 'irk' (collocation + fixed Newton, acados-equivalent) or
      'rk4' (cheaper explicit; accurate for this smooth system at dt=0.1).
    - ``irk_stages`` / ``irk_newton_iter``: acados sim defaults are 4-stage
      Gauss-Legendre with 3 Newton iterations; ``robot_sim.py:25-29`` uses
      3-stage Radau IIA for the standalone demo.
    - ``qp_iter``: interior-point iteration budget (fixed count, masked
      convergence — no data-dependent early exit, XLA-friendly).
    - ``cost_scale_dt``: acados scales path stage costs by the step length
      dt (terminal cost unscaled); kept as a flag for parity experiments.
    - ``compat_pred_bug``: the reference's obstacle-trajectory prediction
      reads ``vx = self.vy`` (``src/utils/visualization.py:69``) — a bug we
      fix by default but can reproduce for apples-to-apples comparisons.
    """

    integrator: str = "irk"
    irk_stages: int = 4
    irk_newton_iter: int = 3
    irk_tableau: str = "gauss_legendre"
    qp_iter: int = 50
    cost_scale_dt: bool = True
    # Levenberg-Marquardt placement: True (default, acados semantics) adds
    # lm INSIDE the dt-scaled stage cost (path stages lm*dt, terminal lm);
    # False adds raw lm on top of the scaled Hessian — ~10x over-damped
    # controls, closed-loop trips ~40% slower than the reference baselines
    # (the round-1/2 behavior, kept for ablation).
    lm_scale_dt: bool = True
    # Whether the slack penalties zl/Zl (robot_ocp_problem.py:145-152) are
    # multiplied by the same dt cost scaling as the stage cost. acados treats
    # slack penalties as part of the stage cost module, so the default True
    # mirrors "cost_scaling multiplies the whole stage cost"; False keeps the
    # reference's raw 1e4*(d^2+50) numbers per stage — a 1/dt (=10x at
    # TF=2/N=20) stronger avoidance penalty relative to the goal cost.
    # Kept as an axis for the seed-matched collision-gap forensics
    # (VERDICT r4 item 1c).
    slack_scale_dt: bool = True
    compat_pred_bug: bool = False
    # IP solver knobs
    ip_tau: float = 0.99         # fraction-to-boundary factor
    ip_reg: float = 1e-9         # static Cholesky regularization
    ip_mu_min: float = 1e-10     # complementarity floor

    # --- acados status-4 reset path (robot_ocp_problem.py:203-205) --------
    # Every bundled baseline run ARMS init_guess_when_error
    # (test_data/*spec.json "init_guess": true): when the QP solver fails,
    # the reference calls set_initial_guess(), which (a) resets the solver's
    # warm start to a stationary guess and (b) — via the aliasing bug at
    # robot_ocp_problem.py:301-302 (``x_guess = self.x0; x_guess[3:] = 0``)
    # — zeroes the PLANT's velocity state, an accidental emergency brake.
    # The analogue of "HPIPM failed within qp_solver_iter_max": the
    # interior point did not converge to (fail_mu_tol, fail_stat_tol) within
    # its fixed qp_iter budget (both measured on the normalized QP, exactly
    # the solver's own freeze criterion in ops/ip_qp.py:363).
    #
    # LEAVE OFF unless studying the failure path: the round-5 seed-matched
    # ablations (results/parity_r5/) show this criterion fires ~9-49x/run at
    # the bundled budgets while the reference's HPIPM evidently almost never
    # did, and the resulting mid-traffic brakes were the whole round-3/4
    # collision excess (hit 24.8% -> 16.4% = reference parity when off).
    init_guess_when_error: bool = False
    fail_mu_tol: float = 1e-7    # duality-measure convergence threshold
    fail_stat_tol: float = 1e-4  # stationarity-residual threshold
    # On failure, also reproduce the plant-velocity-zeroing alias bug (only
    # meaningful with init_guess="current"; the interpolate variant never
    # aliases self.x0 and therefore never brakes the plant).
    compat_brake_bug: bool = True

    # Initial-guess strategy (set_initial_guess, robot_ocp_problem.py:286-306):
    # - "current":     every stage at x0 with v, omega zeroed (the active code)
    # - "interpolate": the commented straight-line variant (:293-300), bugs
    #   reproduced — x never actually interpolates (x0 + i/N*(x0-x0)), psi is
    #   atan2(dy, 0) = +-pi/2 — matching the two bundled interpolate_init runs
    #   (test_data/20221031_2251*/2254*).
    init_guess: str = "current"
