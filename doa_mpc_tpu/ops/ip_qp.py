"""Batched primal-dual interior-point solver for OCP-structured QPs.

Batched replacement for HPIPM (reached by the reference through
``qp_solver='PARTIAL_CONDENSING_HPIPM'`` with ``qp_solver_iter_max=QP_ITER``,
``robot_ocp_problem.py:126,131``). Design points:

- **Mehrotra predictor-corrector** whose Newton systems are solved by a
  block-tridiagonal Riccati sweep (``ops/riccati.py``).
- **Soft (slacked) constraints eliminated stage-wise**: the reference's
  L1+L2 obstacle slacks (``robot_ocp_problem.py:106-122,145-152``) become,
  per interior-point iteration, a rank-M modification C' diag(sigma_eff) C of
  the stage Hessian with
      sigma_eff = sigma_h * (Zl + sigma_s) / (Zl + sigma_h + sigma_s),
  exactly the reduction HPIPM performs for its soft-constrained QPs.
- **Fixed iteration count, masked convergence**: every scenario runs the same
  ``iters`` iterations (static shapes, no data-dependent exit); rows whose
  complementarity has converged take zero-length steps. This is the SPMD
  analogue of HPIPM's ``iter_max``.
- **Infeasible start**: inequality slacks are initialized at
  ``max(expr, t_min)`` and the residual terms carry any initial gap, so no
  phase-1 is needed.

The implementation is batch-generic: all ``qp`` leaves may carry one leading
batch axis (the scenario axis), in which case the duality measure, step
lengths, and convergence freezing are per scenario — the masked divergence
control that replaces acados' status-4 reset path
(robot_ocp_problem.py:203-205). Unbatched single-scenario calls and
``vmap``-ed calls also work.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from doa_mpc_tpu.ops.ocp_qp import IDXBX, OcpQp, normalize_cost
from doa_mpc_tpu.ops.riccati import riccati_factorize, riccati_solve

_T_FLOOR = 1e-12   # slack floor inside sigma = lambda / t
_ZL_FLOOR = 1e-6   # L2 slack-penalty floor: keeps zero-penalty soft rows
                   # (terminal stage: alpha_N = 0, robot_ocp_problem.py:147)
                   # from drifting their slack to infinity along the barrier.


class IpSolution(NamedTuple):
    dx: jnp.ndarray        # (..., N+1, nx)
    du: jnp.ndarray        # (..., N, nu)
    s: jnp.ndarray         # (..., N+1, M) soft slacks
    mu: jnp.ndarray        # (...) final duality measure
    kappa: jnp.ndarray     # (...) objective normalization used internally
    stat_res: jnp.ndarray  # (...) final stationarity residual (normalized)


class _IpState(NamedTuple):
    dx: jnp.ndarray
    du: jnp.ndarray
    s: jnp.ndarray
    nu_dyn: jnp.ndarray    # (..., N, nx) dynamics multipliers
    t_ul: jnp.ndarray; l_ul: jnp.ndarray
    t_uu: jnp.ndarray; l_uu: jnp.ndarray
    t_xl: jnp.ndarray; l_xl: jnp.ndarray
    t_xu: jnp.ndarray; l_xu: jnp.ndarray
    t_h: jnp.ndarray;  l_h: jnp.ndarray
    l_s: jnp.ndarray       # multiplier of s >= 0 (its slack is s itself)


def _sel(dx_stage):
    """E @ dx for the static box selection IDXBX (robot_ocp_problem.py:94),
    statically unrolled."""
    return jnp.stack([dx_stage[..., i] for i in IDXBX], axis=-1)


def _sel_t(v, nx):
    """E' @ v: scatter (..., nbx) back into (..., nx), statically
    unrolled."""
    pos = {s: j for j, s in enumerate(IDXBX)}
    zero = jnp.zeros(v.shape[:-1], v.dtype)
    return jnp.stack([v[..., pos[i]] if i in pos else zero
                      for i in range(nx)], axis=-1)


def solve_ocp_qp(qp: OcpQp, iters: int = 50, tau: float = 0.99,
                 reg: float | None = None, tol: float | None = None,
                 normalize: bool = True,
                 sigma_max: float | None = None,
                 sigma_retry: float | None = None,
                 debug: bool = False) -> IpSolution:
    """Solve OCP QPs (see ``_solve_ocp_qp_impl`` for the algorithm).

    The body runs under ``default_matmul_precision("highest")``: an
    accelerator may run a default f32 dot with reduced-precision passes
    (TF32 on a GPU keeps about three decimal digits), whose rounding
    overflows the condensed Riccati on rare hard rows (captured in
    tests/fixtures/hard_qps_f32.npz); CPU f32 solves the same rows fine.
    The stage products are 5x5, so full f32 costs nothing that matters.
    """
    with jax.default_matmul_precision("highest"):
        return _solve_ocp_qp_impl(
            qp, iters=iters, tau=tau, reg=reg, tol=tol, normalize=normalize,
            sigma_max=sigma_max, sigma_retry=sigma_retry, debug=debug)


def _solve_ocp_qp_impl(qp: OcpQp, iters: int = 50, tau: float = 0.99,
                       reg: float | None = None, tol: float | None = None,
                       normalize: bool = True,
                       sigma_max: float | None = None,
                       sigma_retry: float | None = None,
                       debug: bool = False) -> IpSolution:
    """Solve OCP QPs; ``qp`` leaves may carry one leading batch axis.

    ``iters`` plays the role of the reference's QP_ITER
    (``world_specification.py:48``). Float32 (the production dtype) is
    first-class: barrier terms are clamped (``sigma_max``), iterates are
    floored away from exact zero, and rows freeze once their duality measure
    reaches the dtype's achievable tolerance.
    """
    dtype = qp.Q.dtype
    is32 = dtype == jnp.float32
    tol = (1e-7 if is32 else 1e-10) if tol is None else tol
    reg = (1e-6 if is32 else 1e-9) if reg is None else reg
    if sigma_max is None:
        # On rare ill-conditioned f32 rows a reduced-precision reduction
        # can overflow the condensed Riccati at this clamp (the retry
        # below recovers such rows).
        sigma_max = 1e7 if is32 else 1e12
    if sigma_retry is None:
        # Self-recovery for rows wedged by the non-finite guard: the frozen
        # state reproduces the same overflow every iteration, so the row
        # would stay wedged for the rest of the solve. Instead, a row that
        # trips the guard permanently lowers ITS OWN barrier-curvature
        # clamp to sigma_retry (a masked per-row cap — global restart and
        # adaptive schemes were tried and measured worse) and resumes on
        # the next iteration at some accuracy cost on strongly-active
        # constraints — the analogue of the reference accepting HPIPM's
        # iterate after a status-4 reset (robot_ocp_problem.py:203-205).
        # Pass sigma_retry=0 to disable (rows then freeze permanently).
        sigma_retry = 1e5 if is32 else 1e10
    stat_tol = 1e-4 if is32 else 1e-8
    nx, nu = qp.A.shape[-1], qp.B.shape[-1]
    N = qp.A.shape[-3]
    M = qp.C.shape[-2]
    nbx = len(IDXBX)
    bnd = qp.A.ndim - 3            # number of leading batch axes (0 or 1)

    # --- batch-generic helpers ------------------------------------------
    def rsum(a):
        return jnp.sum(a, axis=tuple(range(bnd, a.ndim)))

    def rmax(a):
        return jnp.max(a, axis=tuple(range(bnd, a.ndim)))

    def rmin(a):
        return jnp.min(a, axis=tuple(range(bnd, a.ndim)))

    def bc(scalar, arr):
        """Broadcast a (batch...) scalar against (batch..., ...) arr."""
        return jnp.reshape(scalar, scalar.shape + (1,) * (arr.ndim - scalar.ndim))

    def stg(a, sl):
        """Slice along the stage axis (first non-batch axis)."""
        return a[(slice(None),) * bnd + (sl,)]

    def cat(parts):
        return jnp.concatenate(parts, axis=bnd)

    def diag_embed(v):
        return v[..., :, None] * jnp.eye(v.shape[-1], dtype=v.dtype)

    if normalize:
        qp, kappa = normalize_cost(qp)
    else:
        kappa = jnp.ones(qp.A.shape[:bnd], dtype)
    Zl = jnp.maximum(qp.Zl, _ZL_FLOOR)

    # --- LQR ----------------------------------------------------------------
    def make_lqr(Qbar, Rbar):
        if bnd == 0:
            fac = riccati_factorize(Qbar, Rbar, qp.S, qp.A, qp.B, reg=reg)

            def lqr(qbar, rbar, d):
                return riccati_solve(fac, qbar, rbar, d,
                                     jnp.zeros((nx,), dtype))
        else:
            fac = jax.vmap(
                lambda Q_, R_, S_, A_, B_: riccati_factorize(
                    Q_, R_, S_, A_, B_, reg=reg)
            )(Qbar, Rbar, qp.S, qp.A, qp.B)

            def lqr(qbar, rbar, d):
                return jax.vmap(riccati_solve)(
                    fac, qbar, rbar, d,
                    jnp.zeros(qp.A.shape[:bnd] + (nx,), dtype))
        return lqr

    # --- initialization -------------------------------------------------
    A_s = jnp.moveaxis(qp.A, bnd, 0)
    c_s = jnp.moveaxis(qp.c, bnd, 0)

    def fwd(dxk, inp):
        Ak, ck = inp
        nxt = jnp.einsum("...ij,...j->...i", Ak, dxk) + ck
        return nxt, nxt

    _, dxs = jax.lax.scan(fwd, qp.dx0, (A_s, c_s))
    dx = cat([qp.dx0[..., None, :], jnp.moveaxis(dxs, 0, bnd)])
    du = jnp.zeros_like(qp.r)

    t_min = jnp.asarray(0.1, dtype)
    g_h = qp.hval + jnp.einsum("...mi,...i->...m", qp.C, dx)
    s0 = jnp.maximum(t_min, t_min - g_h)
    t_h0 = g_h + s0

    mu0 = jnp.asarray(1.0, dtype)

    def init_pair(expr):
        t = jnp.maximum(expr, t_min)
        return t, mu0 / t

    t_ul, l_ul = init_pair(du - qp.lb_u)
    t_uu, l_uu = init_pair(qp.ub_u - du)
    t_xl, l_xl = init_pair(_sel(dx) - qp.lb_x)
    t_xu, l_xu = init_pair(qp.ub_x - _sel(dx))
    t_h = jnp.maximum(t_h0, t_min)
    l_h = mu0 / t_h
    l_s = mu0 / s0

    n_pairs = float(2 * N * nu + 2 * (N + 1) * nbx + 2 * (N + 1) * M)

    state = _IpState(dx, du, s0, jnp.zeros_like(qp.c),
                     t_ul, l_ul, t_uu, l_uu, t_xl, l_xl, t_xu, l_xu,
                     t_h, l_h, l_s)

    def compl_sum(st):
        return (rsum(st.t_ul * st.l_ul) + rsum(st.t_uu * st.l_uu)
                + rsum(st.t_xl * st.l_xl) + rsum(st.t_xu * st.l_xu)
                + rsum(st.t_h * st.l_h) + rsum(st.s * st.l_s))

    zero_x = jnp.zeros(qp.q.shape[:bnd] + (1, nx), dtype)

    def iteration(carry, _):
        st, sig_cap = carry
        # ---- residuals --------------------------------------------------
        r_ul = (st.du - qp.lb_u) - st.t_ul
        r_uu = (qp.ub_u - st.du) - st.t_uu
        r_xl = (_sel(st.dx) - qp.lb_x) - st.t_xl
        r_xu = (qp.ub_x - _sel(st.dx)) - st.t_xu
        g = qp.hval + jnp.einsum("...mi,...i->...m", qp.C, st.dx)
        r_h = (g + st.s) - st.t_h
        r_s = Zl * st.s + qp.zl - st.l_h - st.l_s

        dx_head = stg(st.dx, slice(None, -1))
        dx_tail = stg(st.dx, slice(1, None))
        r_dyn = (dx_tail
                 - jnp.einsum("...ij,...j->...i", qp.A, dx_head)
                 - jnp.einsum("...ij,...j->...i", qp.B, st.du) - qp.c)

        nu_prev = cat([zero_x, st.nu_dyn])                       # nu_{k-1}
        Atnu = cat([jnp.einsum("...ji,...j->...i", qp.A, st.nu_dyn), zero_x])
        r_x = (jnp.einsum("...ij,...j->...i", qp.Q, st.dx) + qp.q
               + cat([jnp.einsum("...ji,...j->...i", qp.S, st.du), zero_x])
               + nu_prev - Atnu
               - _sel_t(st.l_xl - st.l_xu, nx)
               - jnp.einsum("...mi,...m->...i", qp.C, st.l_h))
        r_u = (jnp.einsum("...ij,...j->...i", qp.R, st.du) + qp.r
               + jnp.einsum("...ij,...j->...i", qp.S, dx_head)
               - jnp.einsum("...ij,...i->...j", qp.B, st.nu_dyn)
               - (st.l_ul - st.l_uu))

        # ---- sigmas & condensed Hessian --------------------------------
        def sig(l, t):
            return jnp.clip(l / jnp.maximum(t, _T_FLOOR), 0.0, bc(sig_cap, l))

        s_ul, s_uu = sig(st.l_ul, st.t_ul), sig(st.l_uu, st.t_uu)
        s_xl, s_xu = sig(st.l_xl, st.t_xl), sig(st.l_xu, st.t_xu)
        s_h, s_s = sig(st.l_h, st.t_h), sig(st.l_s, st.s)
        zeta = Zl + s_h + s_s
        s_eff = s_h * (Zl + s_s) / zeta

        Qbar = (qp.Q
                + diag_embed(_sel_t(s_xl + s_xu, nx))
                + jnp.einsum("...mi,...m,...mj->...ij", qp.C, s_eff, qp.C))
        Rbar = qp.R + diag_embed(s_ul + s_uu)

        lqr = make_lqr(Qbar, Rbar)

        mu = compl_sum(st) / n_pairs

        def directions(beta_ul, beta_uu, beta_xl, beta_xu, beta_h, beta_s):
            rho = -r_s + beta_h + beta_s - s_h * r_h
            beta_hat = beta_h - s_h * r_h - s_h * rho / zeta
            qbar = (r_x
                    - _sel_t(beta_xl - s_xl * r_xl, nx)
                    + _sel_t(beta_xu - s_xu * r_xu, nx)
                    - jnp.einsum("...mi,...m->...i", qp.C, beta_hat))
            rbar = r_u - (beta_ul - s_ul * r_ul) + (beta_uu - s_uu * r_uu)
            # The LQR's costate IS the Newton increment Dnu: the Newton rows
            # Qbar*Ddx + S'*Ddu + Dnu_{k-1} - A'*Dnu_k = -qbar match the
            # LQR stationarity with multiplier nu~ = Dnu.
            Ddx, Ddu, Dnu = lqr(qbar, rbar, -r_dyn)
            CDdx = jnp.einsum("...mi,...i->...m", qp.C, Ddx)
            ds = (rho - s_h * CDdx) / zeta
            dt_h = CDdx + ds + r_h
            dl_h = beta_h - s_h * dt_h
            dl_s = beta_s - s_s * ds
            dt_ul = Ddu + r_ul
            dt_uu = -Ddu + r_uu
            dt_xl = _sel(Ddx) + r_xl
            dt_xu = -_sel(Ddx) + r_xu
            dl_ul = beta_ul - s_ul * dt_ul
            dl_uu = beta_uu - s_uu * dt_uu
            dl_xl = beta_xl - s_xl * dt_xl
            dl_xu = beta_xu - s_xu * dt_xu
            return (Ddx, Ddu, Dnu, ds,
                    dt_ul, dl_ul, dt_uu, dl_uu, dt_xl, dl_xl,
                    dt_xu, dl_xu, dt_h, dl_h, dl_s)

        def max_step(vals, tau_f):
            """Largest a in [0,1] with v + a*dv >= (1-tau_f)*v per scenario.

            The division is guarded by substituting the denominator only on
            the unselected branch — clamping |dv| itself would silently cap
            the step for pairs whose v and dv are both legitimately tiny
            (e.g. multipliers of never-active BIG_BOUND rows, ~mu/1e6).
            """
            a = jnp.ones(qp.A.shape[:bnd], dtype)
            for v, dv in vals:
                neg = dv < 0
                denom = jnp.where(neg, -dv, 1.0)
                ratio = jnp.where(neg, tau_f * v / denom, 2.0)
                a = jnp.minimum(a, rmin(ratio))
            return a

        # ---- predictor (affine scaling) --------------------------------
        aff = directions(-st.l_ul, -st.l_uu, -st.l_xl, -st.l_xu,
                         -st.l_h, -st.l_s)
        (Adx, Adu, Anu, As,
         At_ul, Al_ul, At_uu, Al_uu, At_xl, Al_xl,
         At_xu, Al_xu, At_h, Al_h, Al_s) = aff

        prim_aff = [(st.t_ul, At_ul), (st.t_uu, At_uu), (st.t_xl, At_xl),
                    (st.t_xu, At_xu), (st.t_h, At_h), (st.s, As)]
        dual_aff = [(st.l_ul, Al_ul), (st.l_uu, Al_uu), (st.l_xl, Al_xl),
                    (st.l_xu, Al_xu), (st.l_h, Al_h), (st.l_s, Al_s)]
        one = jnp.asarray(1.0, dtype)
        ap_aff = max_step(prim_aff, one)
        ad_aff = max_step(dual_aff, one)

        def compl_after(t, dt, l, dl):
            return rsum((t + bc(ap_aff, t) * dt) * (l + bc(ad_aff, l) * dl))

        mu_aff = (compl_after(st.t_ul, At_ul, st.l_ul, Al_ul)
                  + compl_after(st.t_uu, At_uu, st.l_uu, Al_uu)
                  + compl_after(st.t_xl, At_xl, st.l_xl, Al_xl)
                  + compl_after(st.t_xu, At_xu, st.l_xu, Al_xu)
                  + compl_after(st.t_h, At_h, st.l_h, Al_h)
                  + compl_after(st.s, As, st.l_s, Al_s)) / n_pairs
        sig_c = jnp.clip((mu_aff / jnp.maximum(mu, _T_FLOOR)) ** 3, 0.0, 1.0)
        mu_t = sig_c * mu

        # ---- corrector --------------------------------------------------
        def beta_c(t, l, dt_a, dl_a):
            return (bc(mu_t, t) - t * l - dt_a * dl_a) / jnp.maximum(t, _T_FLOOR)

        cor = directions(
            beta_c(st.t_ul, st.l_ul, At_ul, Al_ul),
            beta_c(st.t_uu, st.l_uu, At_uu, Al_uu),
            beta_c(st.t_xl, st.l_xl, At_xl, Al_xl),
            beta_c(st.t_xu, st.l_xu, At_xu, Al_xu),
            beta_c(st.t_h, st.l_h, At_h, Al_h),
            beta_c(st.s, st.l_s, As, Al_s),
        )
        (Ddx, Ddu, Dnu, Ds,
         Dt_ul, Dl_ul, Dt_uu, Dl_uu, Dt_xl, Dl_xl,
         Dt_xu, Dl_xu, Dt_h, Dl_h, Dl_s) = cor

        prim = [(st.t_ul, Dt_ul), (st.t_uu, Dt_uu), (st.t_xl, Dt_xl),
                (st.t_xu, Dt_xu), (st.t_h, Dt_h), (st.s, Ds)]
        dual = [(st.l_ul, Dl_ul), (st.l_uu, Dl_uu), (st.l_xl, Dl_xl),
                (st.l_xu, Dl_xu), (st.l_h, Dl_h), (st.l_s, Dl_s)]
        tau_f = jnp.asarray(tau, dtype)
        a_p = max_step(prim, tau_f)
        a_d = max_step(dual, tau_f)

        stat = jnp.maximum(rmax(jnp.abs(stg(r_x, slice(1, None)))),
                           rmax(jnp.abs(r_u)))
        converged = (mu < tol) & (stat < jnp.asarray(stat_tol, dtype))
        # safeguard: a non-finite direction freezes the iterate (masked
        # divergence control; the batch keeps marching). The freeze is a
        # select, not a zero step length — 0 * inf would manufacture NaNs.
        # EVERY direction component must be checked: an inf dual step
        # (Dl_*) with finite primal directions would pass a primal-only
        # guard, poison the carried multipliers, and wedge the row for all
        # remaining iterations.
        finite = jnp.isfinite(a_p) & jnp.isfinite(a_d)
        for comp in (Ddx, Ddu, Dnu, Ds, Dt_ul, Dl_ul, Dt_uu, Dl_uu,
                     Dt_xl, Dl_xl, Dt_xu, Dl_xu, Dt_h, Dl_h, Dl_s):
            finite = finite & jnp.isfinite(rsum(comp))
        frozen = converged | ~finite

        tiny = jnp.asarray(1e-30, dtype)

        def upd(old, a, step, positive=False):
            v = old + bc(a, old) * step
            if positive:
                v = jnp.maximum(v, tiny)
            return jnp.where(bc(frozen, old), old, v)

        new = _IpState(
            dx=upd(st.dx, a_p, Ddx),
            du=upd(st.du, a_p, Ddu),
            s=upd(st.s, a_p, Ds, True),
            nu_dyn=upd(st.nu_dyn, a_d, Dnu),
            t_ul=upd(st.t_ul, a_p, Dt_ul, True), l_ul=upd(st.l_ul, a_d, Dl_ul, True),
            t_uu=upd(st.t_uu, a_p, Dt_uu, True), l_uu=upd(st.l_uu, a_d, Dl_uu, True),
            t_xl=upd(st.t_xl, a_p, Dt_xl, True), l_xl=upd(st.l_xl, a_d, Dl_xl, True),
            t_xu=upd(st.t_xu, a_p, Dt_xu, True), l_xu=upd(st.l_xu, a_d, Dl_xu, True),
            t_h=upd(st.t_h, a_p, Dt_h, True), l_h=upd(st.l_h, a_d, Dl_h, True),
            l_s=upd(st.l_s, a_d, Dl_s, True),
        )
        # rows that tripped the non-finite guard lower their own curvature
        # clamp (monotone, one-way) so the next iteration's recomputed
        # direction is finite and the row resumes
        if sigma_retry:
            cap_new = jnp.where(~finite,
                                jnp.minimum(sig_cap,
                                            jnp.asarray(sigma_retry, dtype)),
                                sig_cap)
        else:
            cap_new = sig_cap
        return (new, cap_new), (mu, stat, jnp.minimum(a_p, a_d), sig_c)

    sig_cap0 = jnp.full(qp.A.shape[:bnd], sigma_max, dtype)
    (state, _), (mus, stats, alphas, sigs) = jax.lax.scan(
        iteration, (state, sig_cap0), None, length=iters)

    sol = IpSolution(dx=state.dx, du=state.du, s=state.s,
                     mu=mus[-1], kappa=kappa, stat_res=stats[-1])
    if debug:
        return sol, {"mu": mus, "stat": stats, "alpha": alphas, "sigma": sigs}
    return sol
