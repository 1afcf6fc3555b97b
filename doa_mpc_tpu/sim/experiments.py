"""Batched Monte-Carlo experiment harness.

Replaces the reference's serial 100-seed loop
(``/root/reference/src/simulation/experiments.py:12-46``): all seeds of a
configuration run as ONE batched, optionally mesh-sharded closed-loop scan.
The output artifacts keep the reference's exact schema so downstream
evaluation is drop-in compatible:

- ``<stamp>_experiment_data.csv``: one row per seed, semicolon-delimited,
  columns (hit, reached_goal, min_margin, final_dist, steps, out_of_bounds)
  — the ``ocp.step(400)[1:]`` tuple of robot_ocp_problem.py:277 written at
  experiments.py:36-40.
- ``<stamp>_experiment_spec.json``: the configuration dictionary of
  experiments.py:30.

Config sweeps that the reference performs by string-rewriting
``world_specification.py`` and re-exec-ing itself
(``run_multiple_experiments.py:8-21``) are here just loops over WorldSpec
values — each configuration is a fresh jit specialization, no processes, no
file mutation.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Iterable, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from doa_mpc_tpu.config import (
    CostParams, SolverOptions, WorldSpec, default_cost_params,
)
from doa_mpc_tpu.sim.closed_loop import (
    init_loop_state, metrics_of,
)
from doa_mpc_tpu.sim.obstacles import robot_start_goal
from doa_mpc_tpu.solver.sqp_rti import make_rti_controller


def run_scenario_batch(spec: WorldSpec, opts: SolverOptions, scenario: str,
                       n_runs: int = 100, max_iter: int = 400,
                       seed: int = 0, dtype=jnp.float32,
                       params: CostParams | None = None,
                       mesh=None, start_goal_margin: float = 1.0,
                       return_state: bool = False,
                       compat_rng: bool = False):
    """Run ``n_runs`` seeded scenarios in one batched rollout.

    Start/goal mirror experiments.py:20: start (X_MIN+1, Y_MIN+1, pi/4, 0, 0),
    goal (X_MAX-1, Y_MAX-1). Returns a (n_runs, 6) metrics array in the
    reference CSV column order.

    ``compat_rng`` replays the reference's exact MT19937 streams: row i
    uses the worlds and per-tick obstacle noise that ``np.random.seed(i)``
    produces in the reference (sim/compat_rng.py) — seed-for-seed
    comparable to its bundled CSVs. Incompatible with ``mesh`` (the noise
    trajectory is a host-materialized scan input).
    """
    from doa_mpc_tpu.sim.closed_loop import make_batched_rollout

    ctrl = make_rti_controller(spec, opts, dtype=dtype)
    params = params or default_cost_params(spec, dtype=dtype)
    start, goal = robot_start_goal(spec, margin=start_goal_margin)
    start, goal = start.astype(dtype), goal.astype(dtype)

    if compat_rng:
        if mesh is not None:
            raise ValueError("compat_rng does not support mesh sharding")
        from doa_mpc_tpu.sim.compat_rng import mt_experiment_batch
        obst, noise = mt_experiment_batch(
            range(n_runs), spec, scenario, max_iter=max_iter,
            dtype=np.float64 if dtype == jnp.float64 else np.float32)
        state = init_loop_state(jax.random.PRNGKey(seed), ctrl, start, goal,
                                scenario, batch_shape=(n_runs,), obst=obst)
        rollout = make_batched_rollout(ctrl, goal, params, max_iter=max_iter,
                                       use_noise_traj=True)
        final = jax.jit(rollout)(state, jnp.asarray(noise))
        m = jax.vmap(metrics_of)(final)
        data = np.stack([
            np.asarray(m.hit, np.float64),
            np.asarray(m.reached, np.float64),
            np.asarray(m.min_margin, np.float64),
            np.asarray(m.dist, np.float64),
            np.asarray(m.steps, np.float64),
            np.asarray(m.oob, np.float64),
        ], axis=1)
        if return_state:
            return data, final
        return data

    state = init_loop_state(jax.random.PRNGKey(seed), ctrl, start, goal,
                            scenario, batch_shape=(n_runs,))
    rollout = make_batched_rollout(ctrl, goal, params, max_iter=max_iter)

    if mesh is not None:
        from doa_mpc_tpu.parallel.mesh import (
            make_sharded_rollout, shard_leading_axis,
        )
        if jax.process_count() > 1:
            # multi-host: every process deterministically builds the full
            # batch init (cheap — obstacle placement only), keeps its own
            # contiguous row block, and the blocks are assembled into
            # globally-sharded arrays (parallel/distributed.py).
            from doa_mpc_tpu.parallel.distributed import (
                host_shard_bounds, make_global_batch,
            )
            lo, hi = host_shard_bounds(n_runs)
            local = jax.tree.map(lambda a: np.asarray(a)[lo:hi], state)
            state = make_global_batch(local, mesh)
        else:
            state = shard_leading_axis(state, mesh)
        fn = jax.jit(make_sharded_rollout(rollout, mesh))
        final, _stats = fn(state)
    else:
        final = jax.jit(rollout)(state)

    m = jax.vmap(metrics_of)(final)
    if mesh is not None and jax.process_count() > 1:
        # per-row metrics are sharded across processes; gather so the
        # host-0 CSV writer sees every row
        from doa_mpc_tpu.parallel.distributed import gather_rows
        m = gather_rows(m)
    data = np.stack([
        np.asarray(m.hit, np.float64),
        np.asarray(m.reached, np.float64),
        np.asarray(m.min_margin, np.float64),
        np.asarray(m.dist, np.float64),
        np.asarray(m.steps, np.float64),
        np.asarray(m.oob, np.float64),
    ], axis=1)
    if return_state:
        return data, final
    return data


def run_experiment(spec: WorldSpec | None = None,
                   opts: SolverOptions | None = None,
                   scenarios: Sequence[str] = ("RANDOM", "EDGE"),
                   n_runs: int = 100, max_iter: int = 400,
                   out_dir: str = "test_data/new",
                   dtype=jnp.float32, mesh=None, verbose: bool = True,
                   compat_rng: bool = False):
    """The experiments.py:12-46 driver: per scenario, run the seeded batch
    and persist CSV + spec JSON with the reference's naming convention."""
    spec = spec or WorldSpec()
    opts = opts or SolverOptions(qp_iter=spec.qp_iter)
    from doa_mpc_tpu.parallel.distributed import is_host0
    write = is_host0()   # host-0-only artifact IO in multi-process runs
    if write:
        os.makedirs(out_dir, exist_ok=True)
    results = {}
    for s in scenarios:
        if verbose and write:
            print(f"{s}: solving {n_runs} scenarios (N={spec.n_solv}, "
                  f"M={spec.n_obst}, qp_iter={opts.qp_iter})")
        data = run_scenario_batch(spec, opts, s, n_runs=n_runs,
                                  max_iter=max_iter, dtype=dtype, mesh=mesh,
                                  compat_rng=compat_rng)
        stamp = _unique_stamp(out_dir)
        csv_path = os.path.join(out_dir, f"{stamp}_experiment_data.csv")
        if write:
            np.savetxt(csv_path, data, delimiter=";")
        exp = {
            "slack": True, "random_move": True,
            # the reference schema's "init_guess" records
            # init_guess_when_error (experiments.py:16,31)
            "init_guess": opts.init_guess_when_error,
            "scenario": s, "TF": spec.tf, "N_SOLV": spec.n_solv,
            "N_OBST": spec.n_obst, "QP_ITER": opts.qp_iter,
            # extra provenance (absent from the reference schema)
            "engine": "doa_mpc_tpu", "integrator": opts.integrator,
            "dtype": str(np.dtype(np.float32 if dtype == jnp.float32
                                  else np.float64)),
            "compat_pred_bug": opts.compat_pred_bug,
            "compat_rng": compat_rng,
            "fail_mu_tol": opts.fail_mu_tol,
            "fail_stat_tol": opts.fail_stat_tol,
        }
        if opts.init_guess == "interpolate":
            # the two bundled interpolate runs add this key
            # (test_data/20221031_2251*/2254* spec JSONs)
            exp["interpolate_init"] = True
        if write:
            with open(os.path.join(out_dir, f"{stamp}_experiment_spec.json"),
                      "w") as f:
                json.dump(exp, f)
        results[s] = data
        if verbose and write:
            print(f"  collision={data[:, 0].mean():.2%} "
                  f"reached={data[:, 1].mean():.2%} "
                  f"oob={data[:, 5].mean():.2%} "
                  f"median_steps={np.median(data[:, 4]):.0f}")
    return results


def _unique_stamp(out_dir: str) -> str:
    """The reference's ``%Y%m%d_%H%M%S`` file prefix, suffixed ``_1``,
    ``_2``... when a run that finished within the same second already
    holds it (a scenario batch can take less than a second on a GPU)."""
    base = stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    n = 0
    while os.path.exists(os.path.join(out_dir,
                                      f"{stamp}_experiment_data.csv")):
        n += 1
        stamp = f"{base}_{n}"
    return stamp


def run_horizon_sweep(tf_values: Iterable[float] = (0.5, 1, 1.5, 2, 2.5, 3),
                      n_obst_values: Iterable[int] = (5, 10, 15, 20, 25, 30),
                      **kw):
    """The run_multiple_experiments.py:4-31 sweep (TF x N_OBST grid) with
    config-as-data instead of source-file rewriting."""
    out = {}
    for tf in tf_values:
        for m in n_obst_values:
            spec = WorldSpec(tf=float(tf), n_solv=int(tf * 10), n_obst=int(m))
            out[(tf, m)] = run_experiment(spec=spec, **kw)
    return out


def run_qp_iter_sweep(qp_iters: Iterable[int] = (25, 50, 100, 150), **kw):
    """The run_experiments_qp_solver sweep (run_multiple_experiments.py:33-41)."""
    out = {}
    for it in qp_iters:
        spec = WorldSpec(qp_iter=int(it))
        opts = SolverOptions(qp_iter=int(it))
        out[it] = run_experiment(spec=spec, opts=opts, **kw)
    return out
