"""ctypes bindings for the native CPU OCP core (``native/ocp_core.cpp``).

Loads the dependency-free C++ library that mirrors the reference's acados-C
tier, building it from ``native/ocp_core.cpp`` into ``native/build/`` on
first use (``make -C native`` does the same by hand):

- ``ip_solve`` — the FULL production QP (box constraints + L1/L2-slacked
  obstacle constraints, robot_ocp_problem.py:106-122) solved by the same
  Mehrotra predictor-corrector algorithm as ``ops/ip_qp.py``, f64, single
  scenario with early exit. This is the single-scenario CPU runtime for
  deployments without an accelerator AND an independent oracle for the
  production QP path (tests/test_native.py cross-checks it against the
  f64 JAX solver).
- ``riccati_solve`` — the unconstrained dense Riccati LQR.
- ``rk4_step`` / ``irk3_step`` — the unicycle integrators.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SRC_PATH = os.path.join(_NATIVE_DIR, "ocp_core.cpp")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libocp_core.so")
_lib = None


def _build():
    """Compile the library unless an up-to-date one exists.

    Several processes (pytest-xdist workers) may ask at once: the build
    runs under an exclusive file lock and writes a temporary file that is
    renamed into place, so no process ever loads a half-written library.
    """
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    with open(_LIB_PATH + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH)
                >= os.path.getmtime(_SRC_PATH)):
            return
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, f"OUT={tmp}"],
                           check=True, capture_output=True)
            os.replace(tmp, _LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    _build()
    lib = ctypes.CDLL(_LIB_PATH)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.ocp_riccati_solve.restype = ctypes.c_int
    lib.ocp_riccati_solve.argtypes = (
        [ctypes.c_int] * 3 + [dp] * 9 + [ctypes.c_double] + [dp] * 2)
    lib.unicycle_rk4.restype = None
    lib.unicycle_rk4.argtypes = [dp, dp, ctypes.c_double, dp]
    lib.unicycle_irk3.restype = None
    lib.unicycle_irk3.argtypes = [dp, dp, ctypes.c_double, ctypes.c_int, dp]
    ip = ctypes.POINTER(ctypes.c_int)
    lib.ocp_ip_solve.restype = ctypes.c_int
    lib.ocp_ip_solve.argtypes = (
        [ctypes.c_int] * 5 + [ip] + [dp] * 17 + [ctypes.c_int]
        + [ctypes.c_double] * 5 + [dp] * 5)
    lib.unicycle_rk4_sens.restype = None
    lib.unicycle_rk4_sens.argtypes = [dp, dp, ctypes.c_double, dp, dp, dp]
    lib.ocp_closed_loop_run.restype = ctypes.c_int
    lib.ocp_closed_loop_run.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_double] * 11 + [dp] * 3
        + [ctypes.c_double] * 6 + [dp] * 5 + [ctypes.c_int]
        + [ctypes.c_double] * 4 + [dp] * 3 + [ip] * 2)
    _lib = lib
    return lib


def available() -> bool:
    """True if the library builds (a C++ compiler and make are present)
    and loads."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _c(arr):
    a = np.ascontiguousarray(arr, dtype=np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def riccati_solve(Q, q, R, r, S, A, B, d, x0, reg: float = 0.0):
    """Native dense Riccati solve; same problem as ops.riccati."""
    lib = _load()
    N, nx, nu = A.shape[0], A.shape[1], B.shape[2]
    x_out = np.zeros((N + 1, nx))
    u_out = np.zeros((N, nu))
    holds = [_c(v) for v in (Q, q, R, r, S, A, B, d, x0)]
    ptrs = [h[1] for h in holds]
    xo, xo_p = _c(x_out)
    uo, uo_p = _c(u_out)
    status = lib.ocp_riccati_solve(N, nx, nu, *ptrs, ctypes.c_double(reg),
                                   xo_p, uo_p)
    if status != 0:
        raise RuntimeError(f"native riccati failed with status {status}")
    return xo, uo


def ip_solve(qp, idxbx, iters: int = 50, tau: float = 0.99,
             reg: float = 1e-9, tol: float = 1e-10, stat_tol: float = 1e-8,
             sigma_max: float = 1e12, normalize: bool = True):
    """Native soft-constrained interior-point solve of one OCP QP.

    ``qp`` is an ``ops.ocp_qp.OcpQp`` WITHOUT a batch axis (single
    scenario); ``idxbx`` the static state-box selection. Returns
    ``(dx, du, s, mu, stat, iters_used)``; ``iters_used`` is -1 if the
    solve stopped on a non-finite direction (iterate kept at the last
    finite state) — the caller's status-4 analogue.

    ``normalize`` rescales the objective so its largest coefficient is O(1)
    before solving (ops.ocp_qp.normalize_cost semantics) — the production
    slack penalties reach ~1e6 while R has entries 0.15, a spread that
    stalls ANY interior point; the primal solution is unchanged and the
    returned mu/stat are in normalized units, matching the JAX solver.
    """
    lib = _load()
    N, nx, nu = qp.A.shape[0], qp.A.shape[1], qp.B.shape[2]
    M, nbx = qp.C.shape[1], len(idxbx)
    if normalize:
        kappa = max(float(np.max(np.abs(np.diagonal(
                        np.asarray(qp.Q), axis1=-2, axis2=-1)))),
                    float(np.max(np.abs(np.diagonal(
                        np.asarray(qp.R), axis1=-2, axis2=-1)))),
                    float(np.max(np.asarray(qp.zl))),
                    float(np.max(np.asarray(qp.Zl))), 1.0)
        inv = 1.0 / kappa
        qp = qp._replace(
            Q=np.asarray(qp.Q) * inv, q=np.asarray(qp.q) * inv,
            R=np.asarray(qp.R) * inv, r=np.asarray(qp.r) * inv,
            S=np.asarray(qp.S) * inv,
            zl=np.asarray(qp.zl) * inv, Zl=np.asarray(qp.Zl) * inv)
    idx = np.ascontiguousarray(np.asarray(idxbx, np.int32))
    holds = [_c(np.asarray(v)) for v in
             (qp.A, qp.B, qp.c, qp.dx0, qp.Q, qp.q, qp.R, qp.r, qp.S,
              qp.lb_u, qp.ub_u, qp.lb_x, qp.ub_x, qp.C, qp.hval,
              qp.zl, qp.Zl)]
    ptrs = [h[1] for h in holds]
    dx, dx_p = _c(np.zeros((N + 1, nx)))
    du, du_p = _c(np.zeros((N, nu)))
    s, s_p = _c(np.zeros((N + 1, M)))
    mu = ctypes.c_double()
    stat = ctypes.c_double()
    used = lib.ocp_ip_solve(
        N, nx, nu, M, nbx, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        *ptrs, iters, ctypes.c_double(tau), ctypes.c_double(reg),
        ctypes.c_double(tol), ctypes.c_double(stat_tol),
        ctypes.c_double(sigma_max), dx_p, du_p, s_p,
        ctypes.byref(mu), ctypes.byref(stat))
    return dx, du, s, mu.value, stat.value, used


def rk4_step(x, u, dt: float):
    lib = _load()
    out = np.zeros(5)
    xa, xp = _c(x)
    ua, up = _c(u)
    oa, op = _c(out)
    lib.unicycle_rk4(xp, up, ctypes.c_double(dt), op)
    return oa


def rk4_sens(x, u, dt: float):
    """RK4 step plus exact sensitivities (Phi, dPhi/dx, dPhi/du)."""
    lib = _load()
    out, A, B = np.zeros(5), np.zeros((5, 5)), np.zeros((5, 2))
    xa, xp = _c(x)
    ua, up = _c(u)
    oa, op = _c(out)
    Aa, Ap = _c(A)
    Ba, Bp = _c(B)
    lib.unicycle_rk4_sens(xp, up, ctypes.c_double(dt), op, Ap, Bp)
    return oa, Aa, Ba


def closed_loop_run(spec, params, goal, x0, obst_pos, obst_vel,
                    max_iter: int = 400, qp_iter: int | None = None,
                    noise=None, cost_scale_dt: bool = True,
                    slack_scale_dt: bool = True, lm_scale_dt: bool = True,
                    compat_pred_bug: bool = False, ip_tau: float = 0.99,
                    ip_reg: float = 1e-9, ip_tol: float = 0.0,
                    ip_stat_tol: float = 0.0):
    """Run the ENTIRE closed-loop RTI simulation in the native C++ runtime.

    The standalone host-only controller (``native/ocp_core.cpp
    ocp_closed_loop_run``): obstacle forecast, Gauss-Newton QP assembly,
    Mehrotra interior point, RK4 plant step, warm-start shift — no JAX
    anywhere. Mirrors ``sim/closed_loop.make_rollout`` with
    ``integrator='rk4'`` and the status-4 analogue off; serves as the
    independent end-to-end oracle in tests/test_native.py.

    ``noise``: optional (T, M, 2) standard-normal draws for the obstacle
    motion noise (None = noise-free world). ``ip_tol``/``ip_stat_tol`` = 0
    disables the interior point's early exit so the fixed ``qp_iter``
    budget matches the JAX solver's fixed-iteration semantics.

    Returns dict with x_hist (T+1, 5), u_hist (T, 2), min_margin, steps,
    reached, ticks.
    """
    lib = _load()
    T = max_iter
    M = spec.n_obst
    qp_iter = spec.qp_iter if qp_iter is None else qp_iter
    flags = ((1 if cost_scale_dt else 0) | (2 if slack_scale_dt else 0)
             | (4 if lm_scale_dt else 0) | (8 if compat_pred_bug else 0))
    holds = [_c(np.asarray(v)) for v in
             (params.q_diag, params.r_diag, params.qe_diag,
              x0, goal, np.asarray(obst_pos).reshape(M, 2),
              np.asarray(obst_vel).reshape(M, 2))]
    if noise is not None:
        nh = _c(np.asarray(noise).reshape(T, M, 2))
        noise_p = nh[1]
    else:
        noise_p = None
    x_hist, xh_p = _c(np.zeros((T + 1, 5)))
    u_hist, uh_p = _c(np.zeros((T, 2)))
    mm = ctypes.c_double()
    steps = ctypes.c_int()
    reached = ctypes.c_int()
    ticks = lib.ocp_closed_loop_run(
        spec.n_solv, M, T, qp_iter, ctypes.c_double(spec.dt),
        *[ctypes.c_double(v) for v in
          (spec.x_min, spec.x_max, spec.y_min, spec.y_max, spec.r_obst,
           spec.r_robot, spec.margin, spec.tol, spec.randomness,
           spec.v_max_obst)],
        holds[0][1], holds[1][1], holds[2][1],
        *[ctypes.c_double(float(v)) for v in
          (params.lm_reg, params.slack_scale, params.slack_offset,
           params.x_bound, params.v_bound, params.u_bound)],
        holds[3][1], holds[4][1], holds[5][1], holds[6][1], noise_p,
        flags, ctypes.c_double(ip_tau), ctypes.c_double(ip_reg),
        ctypes.c_double(ip_tol), ctypes.c_double(ip_stat_tol),
        xh_p, uh_p, ctypes.byref(mm), ctypes.byref(steps),
        ctypes.byref(reached))
    return dict(x_hist=x_hist, u_hist=u_hist, min_margin=mm.value,
                steps=steps.value, reached=bool(reached.value),
                ticks=ticks)


def irk3_step(x, u, dt: float, iters: int = 10):
    lib = _load()
    out = np.zeros(5)
    xa, xp = _c(x)
    ua, up = _c(u)
    oa, op = _c(out)
    lib.unicycle_irk3(xp, up, ctypes.c_double(dt), iters, op)
    return oa
