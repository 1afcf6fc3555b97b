"""Fleet benchmark: batched MPC solves/s on one GPU at N=20.

The reference controller's implicit real-time budget is one RTI solve per
dt = TF/N = 0.1 s control tick (``world_specification.py:43-44``), i.e. 10
solves/s on its CPU. This benchmark runs the full production control tick
(obstacle forecast -> RTI linearize -> batched interior-point QP -> plant
step -> noisy world step -> metrics) for ``BATCH`` concurrent scenarios on
the default device and reports throughput in MPC solves per second, plus
the latency of one robot's tick (B=1).

Timing: each jitted tick is compiled and warmed up first (compile time is
reported on its own), then timed on the host clock around
``block_until_ready``; the reported values are medians (and the B=1 p99)
over the repeats. Without a GPU the run fails rather than reporting a CPU
number.

Prints exactly one JSON line (the last line of stdout).

    python bench.py
"""

import json
import time

import numpy as np

BATCH = 4096
REPS = 50          # B=4096 ticks timed
B1_REPS = 200      # B=1 ticks timed (enough samples for a p99)
# 6 interior-point iterations per RTI tick: the controller warm-starts the
# QP primal by shifting the previous solution, so few IP iterations suffice.
# The persisted sweep (results/iter_sweep_r3/, 256 seeds x 2 scenarios per
# count) locates the quality cliff at 2 iterations; the seed-matched
# re-validation (results/parity_r5/qp_budget/ + prod_rk4_qp6/) shows 6
# iterations hold reference quality on the reference's own worlds across
# all 10 bundled cells, while 4 slow trips by 36%.
QP_ITER = 6


def time_ticks(tick, state, reps):
    """(compile_s, per-tick times) of jitted ``tick`` chained ``reps``
    times from ``state``."""
    import jax

    t0 = time.perf_counter()
    step = jax.jit(tick).lower(state).compile()
    compile_s = time.perf_counter() - t0
    state = jax.block_until_ready(step(state))        # warm-up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = jax.block_until_ready(step(state))
        times.append(time.perf_counter() - t0)
    return compile_s, np.asarray(times)


def measure():
    import jax
    import jax.numpy as jnp

    from doa_mpc_tpu.config import SolverOptions, WorldSpec, default_cost_params
    from doa_mpc_tpu.sim.closed_loop import init_loop_state, make_batched_tick
    from doa_mpc_tpu.sim.obstacles import robot_start_goal
    from doa_mpc_tpu.solver.sqp_rti import make_rti_controller
    from doa_mpc_tpu.utils.compile_cache import enable_compile_cache
    from doa_mpc_tpu.utils.profiling import (
        gpu_name_and_power_limit, require_gpu)

    device = require_gpu()
    enable_compile_cache()
    dtype = jnp.float32
    spec = WorldSpec(tf=2.0, n_solv=20, qp_iter=QP_ITER)
    opts = SolverOptions(qp_iter=QP_ITER, integrator="rk4")
    ctrl = make_rti_controller(spec, opts, dtype=dtype)
    params = default_cost_params(spec, dtype=dtype)
    start, goal = robot_start_goal(spec)
    start, goal = start.astype(dtype), goal.astype(dtype)
    tick = make_batched_tick(ctrl, goal, params)

    state = init_loop_state(jax.random.PRNGKey(0), ctrl, start, goal,
                            "RANDOM", batch_shape=(BATCH,))
    compile_s, times = time_ticks(tick, state, REPS)
    tick_s = float(np.median(times))

    st1 = init_loop_state(jax.random.PRNGKey(1), ctrl, start, goal,
                          "RANDOM", batch_shape=(1,))
    b1_compile_s, b1 = time_ticks(tick, st1, B1_REPS)

    return {
        "metric": "mpc_solves_per_s_N20",
        "value": BATCH / tick_s,
        "unit": "solves/s",
        "batch": BATCH,
        "qp_iter": QP_ITER,
        "median_tick_s": tick_s,
        "compile_s": compile_s,
        "reps": REPS,
        "b1_median_tick_s": float(np.median(b1)),
        "b1_p99_tick_s": float(np.quantile(b1, 0.99)),
        "b1_compile_s": b1_compile_s,
        "b1_reps": B1_REPS,
        "realtime_ok": bool(np.quantile(b1, 0.99) < spec.dt),
        "platform": device["platform"],
        "device_kind": device["kind"],
        "device_count": device["count"],
        "gpu": gpu_name_and_power_limit(),
    }


def main():
    print(json.dumps(measure()), flush=True)


if __name__ == "__main__":
    main()
