"""Smoke test of the MPC engine on the GPU, through its user entry points.

    python chip_smoke.py          # one GPU: phases (a)-(d)
    python chip_smoke.py --four   # four GPUs: phase (e) only

Phases, each a function; any failure raises and the script exits non-zero
without printing a result line:

(a) device check: JAX's default device must be a GPU; prints the card's
    name and power limit, the JAX version and the device kind.
(b) the reference experiment through ``cli.main``: 100 seeds x {RANDOM,
    EDGE}, TF=2, N=20, M=5, 400 ticks, CLI defaults (rk4, qp_iter 20),
    plus a short IRK experiment. The first 10 ticks of every row (against
    the CPU device of this process) and the final rates (against CPU-only
    child processes) are checked against the same seeds run in f32 on the
    CPU.
(c) the fleet tick (B=4096, N=20, M=5, qp_iter 6): compile time, memory
    analysis, peak memory, and the tick timed end to end at B=4096 and
    B=1; the long-horizon corner N=40, M=8 runs too.
(d) the interior-point solver in f32 on the GPU and on the CPU against a
    converged f64 oracle on the CPU, on QPs taken mid-rollout at
    N=20/M=5 and N=40/M=8.
(e) (--four) the experiment sharded over four GPUs at 4 x 1024 scenarios
    against the same seeds unsharded on GPU 0.

The last line of standard output is the JSON result
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

FLEET_B = 4096
REPS = 20
ORACLE_ROWS = 256


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# (a) device
# ---------------------------------------------------------------------------

def check_device() -> dict:
    """The default device's platform, kind and count; raises unless it is
    a GPU."""
    import jax

    from doa_mpc_tpu.utils.profiling import require_gpu

    return require_gpu() | {"jax": jax.__version__}


def phase_device():
    from doa_mpc_tpu.utils.profiling import gpu_name_and_power_limit

    device = check_device()
    log("[a] nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    log(gpu_name_and_power_limit())
    log(f"[a] jax {device['jax']}, {device['count']} x {device['kind']}")
    return device


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _controller(N=20, M=5, qp_iter=6, integrator="rk4", tf=None,
                dtype=np.float32):
    from doa_mpc_tpu.config import SolverOptions, WorldSpec, default_cost_params
    from doa_mpc_tpu.sim.obstacles import robot_start_goal
    from doa_mpc_tpu.solver.sqp_rti import make_rti_controller

    spec = WorldSpec(tf=0.1 * N if tf is None else tf, n_solv=N, n_obst=M,
                     qp_iter=qp_iter)
    opts = SolverOptions(qp_iter=qp_iter, integrator=integrator)
    ctrl = make_rti_controller(spec, opts, dtype=dtype)
    params = default_cost_params(spec, dtype=dtype)
    start, goal = robot_start_goal(spec)
    return ctrl, params, start.astype(dtype), goal.astype(dtype)


def _init(ctrl, start, goal, scenario, B, seed=0):
    import jax

    from doa_mpc_tpu.sim.closed_loop import init_loop_state

    return init_loop_state(jax.random.PRNGKey(seed), ctrl, start, goal,
                           scenario, batch_shape=(B,))


def _cpu():
    import jax

    return jax.devices("cpu")[0]


def _rollout_x0(device, scenario, ticks, B=100, **ctl):
    """Per-tick robot states (ticks, B, nx) of the seed-0 batch, run on
    ``device``."""
    import jax

    from doa_mpc_tpu.sim.closed_loop import make_batched_rollout

    ctrl, params, start, goal = _controller(**ctl)
    with jax.default_device(device):
        st = _init(ctrl, start, goal, scenario, B)
        roll = make_batched_rollout(ctrl, goal, params, max_iter=ticks,
                                    collect=True)
        _, (x0s, _) = jax.jit(roll)(st)
        return np.asarray(x0s)


# ---------------------------------------------------------------------------
# (b) the reference experiment through the CLI
# ---------------------------------------------------------------------------

# First-10-tick agreement with the CPU run, per row: a row agrees if its
# state stays within TRAJ_ATOL (m, rad, m/s, rad/s) of the CPU row over the
# first 10 ticks. The GPU and the CPU run the same f32 program with other
# fusions and summation orders, and some mid-traffic QPs are
# ill-conditioned in f32 (their f32 solutions sit far from the f64 one,
# phase d): there last-bit differences pick visibly different controls
# within a few ticks. On the CPU, two f32 interior points that differ only
# in association order kept 86% of RANDOM rows and 100% of EDGE rows
# within 1e-2 over 10 ticks at 100 seeds, with a median row deviation
# below 1e-5. So: at least TRAJ_FRAC of the rows within TRAJ_ATOL and the
# median row within TRAJ_MEDIAN. A broken solver moves nearly every row by
# tenths within a few ticks.
TRAJ_ATOL, TRAJ_FRAC, TRAJ_MEDIAN = 1e-2, 0.75, 1e-3


def _binomial_band(p_ref, n):
    """Allowed |rate - rate_ref| between two runs of the same seeds: three
    standard deviations of the difference of two independent binomial
    rates, plus one row. Same seeds make the runs far from independent,
    so this is loose for agreement and tight for a broken solver (which
    moves reach rates by tens of points)."""
    p = min(max(p_ref, 1.0 / n), 1.0 - 1.0 / n)
    return 3.0 * np.sqrt(2.0 * p * (1.0 - p) / n) + 1.0 / n


def _rates(out_dir):
    from doa_mpc_tpu.sim.evaluate import load_experiment_data

    return {spec["scenario"]: (float(d[:, 0].mean()), float(d[:, 1].mean()))
            for spec, d in load_experiment_data(out_dir)}


RUNS, TICKS, SCENARIOS = 100, 400, ("RANDOM", "EDGE")


def cpu_reference(scenario, runs, ticks, out_json):
    """Child-process body: the seed-0 experiment batch in f32 on the CPU;
    writes the per-row metrics as JSON."""
    import jax

    from doa_mpc_tpu.config import SolverOptions, WorldSpec
    from doa_mpc_tpu.sim.experiments import run_scenario_batch

    if jax.devices()[0].platform != "cpu":
        raise RuntimeError("the CPU reference must run with JAX_PLATFORMS=cpu")
    # keep to the last few cores, so the GPU phases' host side (timed in
    # phase c) keeps the rest
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[-max(1, len(cores) // 4):])
    data = run_scenario_batch(WorldSpec(), SolverOptions(qp_iter=20),
                              scenario, n_runs=int(runs),
                              max_iter=int(ticks))
    with open(out_json, "w") as f:
        json.dump(data.tolist(), f)


def start_cpu_references(tmp):
    """Start one CPU-only child per scenario (JAX_PLATFORMS=cpu: they never
    open the GPU). A 400-tick CPU run takes minutes, so they run while the
    GPU phases do."""
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return {s: (subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-reference", s,
         str(RUNS), str(TICKS), os.path.join(tmp, f"{s}.json")], env=env),
        os.path.join(tmp, f"{s}.json")) for s in SCENARIOS}


def phase_experiment():
    """The reference experiment on the GPU through the CLI, its IRK
    variant, and the first 10 ticks of every row against the CPU run.
    Returns the GPU's (hit, reached) rates per scenario."""
    import jax

    from doa_mpc_tpu.cli import main as cli_main

    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        cli_main(["experiment", "--runs", str(RUNS), "--max-iter",
                  str(TICKS), "--out", out, "--scenarios", *SCENARIOS])
        wall = time.perf_counter() - t0
        gpu_rates = _rates(out)
    log(f"[b] cli experiment, {RUNS} seeds x {SCENARIOS}, {TICKS} ticks: "
        f"{wall:.1f} s wall incl. compile")
    for s in SCENARIOS:
        log(f"[b] {s} gpu: hit rate {gpu_rates[s][0]:.2f}, reached rate "
            f"{gpu_rates[s][1]:.2f}")

    for s in SCENARIOS:
        gpu_x = _rollout_x0(jax.devices()[0], s, 10, B=RUNS, N=20, M=5,
                            qp_iter=20, tf=2.0)
        cpu_x = _rollout_x0(_cpu(), s, 10, B=RUNS, N=20, M=5, qp_iter=20,
                            tf=2.0)
        dev = np.abs(gpu_x - cpu_x).max(axis=(0, 2))   # per row
        frac = float(np.mean(dev <= TRAJ_ATOL))
        log(f"[b] {s} first 10 ticks, per-row max |x_gpu - x_cpu|: "
            f"median {np.median(dev):.2e}, max {dev.max():.2e}, "
            f"{frac:.0%} of rows within {TRAJ_ATOL} (need {TRAJ_FRAC:.0%}, "
            f"median <= {TRAJ_MEDIAN})")
        if not (frac >= TRAJ_FRAC and np.median(dev) <= TRAJ_MEDIAN):
            raise AssertionError(f"{s} trajectories differ from the CPU run")

    with tempfile.TemporaryDirectory() as out:
        cli_main(["experiment", "--integrator", "irk", "--runs", "32",
                  "--max-iter", "100", "--out", out, "--scenarios", "RANDOM"])
        hit, reached = _rates(out)["RANDOM"]
    log(f"[b] irk experiment, 32 seeds, 100 ticks: hit rate {hit:.2f}, "
        f"reached rate {reached:.2f}")
    if not (0.0 <= hit <= 1.0 and 0.0 <= reached <= 1.0):
        raise AssertionError("irk experiment produced no rates")
    return gpu_rates


def phase_experiment_rates(gpu_rates, refs):
    """Final hit and reached rates of the GPU run against the CPU run."""
    for s, (proc, path) in refs.items():
        if proc.wait(timeout=900) != 0:
            raise AssertionError(f"CPU reference {s} failed")
        with open(path) as f:
            ref = np.asarray(json.load(f))
        for col, name in ((0, "hit"), (1, "reached")):
            r_gpu, r_cpu = gpu_rates[s][col], float(ref[:, col].mean())
            band = _binomial_band(r_cpu, RUNS)
            log(f"[b] {s} {name} rate: gpu {r_gpu:.2f}, cpu-xla {r_cpu:.2f}"
                f" (band +-{band:.3f})")
            if abs(r_gpu - r_cpu) > band:
                raise AssertionError(f"{s} {name} rate outside the band")


# ---------------------------------------------------------------------------
# (c) the fleet tick
# ---------------------------------------------------------------------------

def _timed_tick(tick, state, reps=REPS):
    """(compile_s, compiled, median_s, final_state) of the jitted tick."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(tick).lower(state).compile()
    compile_s = time.perf_counter() - t0
    state = jax.block_until_ready(compiled(state))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = jax.block_until_ready(compiled(state))
        times.append(time.perf_counter() - t0)
    return compile_s, compiled, float(np.median(times)), state


def phase_fleet_tick():
    import jax

    from doa_mpc_tpu.sim.closed_loop import make_batched_tick

    dev = jax.devices()[0]
    for N, M, sizes, reps in ((20, 5, (FLEET_B, 1), REPS),
                              (40, 8, (FLEET_B,), 5)):
        ctrl, params, start, goal = _controller(N=N, M=M, qp_iter=6)
        tick = make_batched_tick(ctrl, goal, params)
        for B in sizes:
            st = _init(ctrl, start, goal, "RANDOM", B)
            c_s, compiled, med, fin = _timed_tick(tick, st, reps)
            if not np.isfinite(np.asarray(fin.x0)).all():
                raise AssertionError(f"N={N} B={B}: non-finite state")
            log(f"[c] tick N={N} M={M} B={B}: compile {c_s:.1f} s, median "
                f"{med * 1e3:.3f} ms over {reps} ticks, "
                f"{B / med:.0f} solves/s")
            if B == FLEET_B and N == 20:
                log(f"[c] N={N} B={B} memory_analysis: "
                    f"{compiled.memory_analysis()}")
    log(f"[c] peak_bytes_in_use: {dev.memory_stats()['peak_bytes_in_use']}")


# ---------------------------------------------------------------------------
# (d) the solver against an f64 oracle
# ---------------------------------------------------------------------------

ORACLE_ITERS = 80
ABS_MU = 1e-6


def _mid_rollout_qps(N, M):
    """build_qp QPs of FLEET_B scenarios after 5 ticks of the closed loop."""
    import jax
    import jax.numpy as jnp

    from doa_mpc_tpu.sim.closed_loop import make_batched_tick
    from doa_mpc_tpu.sim.obstacles import predict_trajectory

    ctrl, params, start, goal = _controller(N=N, M=M, qp_iter=20)
    tick = jax.jit(make_batched_tick(ctrl, goal, params))
    st = _init(ctrl, start, goal, "RANDOM", FLEET_B, seed=7)
    for _ in range(5):
        st = tick(st)
    spec = ctrl.spec

    @jax.jit
    def build(st):
        pred = jnp.moveaxis(predict_trajectory(st.obst, spec, spec.n_solv),
                            0, 1)
        return jax.vmap(lambda r, x, p: ctrl.build_qp(r, x, goal, p, params)
                        )(st.rti, st.x0, pred)
    return build(st)


def phase_numerics():
    """The f32 solve on the GPU must track a converged f64 solve at least
    as well as the same f32 solve on the CPU does."""
    import jax

    from doa_mpc_tpu.ops.ip_qp import solve_ocp_qp

    log("[d] matmul precision: every f32 dot in the tick and in the solver "
        "runs at 'highest' (full f32, no TF32)")
    q = lambda e, p: float(np.quantile(e, p))
    for N, M in ((20, 5), (40, 8)):
        qp = _mid_rollout_qps(N, M)
        sub = jax.tree.map(lambda a: np.asarray(a)[:ORACLE_ROWS], qp)
        with jax.enable_x64(True), jax.default_device(_cpu()):
            q64 = jax.tree.map(lambda a: a.astype(np.float64), sub)
            du_ref = np.asarray(jax.jit(lambda q: solve_ocp_qp(
                q, iters=ORACLE_ITERS))(q64).du)
        for iters in (20, 50):
            solve = jax.jit(lambda q: solve_ocp_qp(q, iters=iters))
            gpu = solve(qp)
            with jax.default_device(_cpu()):
                cpu = solve(jax.device_put(sub, _cpu()))
            if not np.isfinite(np.asarray(gpu.du)).all():
                raise AssertionError(f"N={N}: non-finite du on the GPU")
            err = {name: np.abs(np.asarray(sol.du)[:ORACLE_ROWS]
                                - du_ref).max(axis=(1, 2))
                   for name, sol in (("gpu", gpu), ("cpu", cpu))}
            mu = np.median(np.asarray(gpu.mu))
            log(f"[d] N={N} M={M} iters={iters}, {ORACLE_ROWS} QPs: "
                f"|du - du_f64| median gpu {q(err['gpu'], .5):.2e} cpu "
                f"{q(err['cpu'], .5):.2e}; p95 gpu {q(err['gpu'], .95):.2e} "
                f"cpu {q(err['cpu'], .95):.2e}; median mu gpu {mu:.1e} "
                f"(all {FLEET_B} QPs)")
            # 2x slack for f32 rounding in another order; floors for rows
            # that both solve to within f32 resolution of the 1e4 slack
            # weights.
            if not (q(err["gpu"], .5) <= max(2 * q(err["cpu"], .5), 1e-3)
                    and q(err["gpu"], .95)
                    <= max(2 * q(err["cpu"], .95), 1e-2)):
                raise AssertionError(f"GPU error worse than CPU f32, N={N}")
            if iters == 50 and not mu < ABS_MU:
                raise AssertionError(f"mu not converged on the GPU, N={N}")


# ---------------------------------------------------------------------------
# (e) four cards
# ---------------------------------------------------------------------------

# Sharded rows run the same per-row arithmetic as the one-card run, but
# XLA tiles the per-row reductions (sums over stages and pairs) differently
# for 1,024 rows than for 4,096. In f32 an ill-conditioned row amplifies
# that last-bit difference over 20 ticks: on 4 H100s only 56% of f32 rows
# stayed within 1e-4 (median 3.9e-5, max 19). The comparison therefore runs
# in f64, where those QPs are well conditioned. Even there a discrete
# decision (convergence freeze, step-length minimum, goal reached) flips on
# a last-bit difference in some rows and sends them apart: on 4 H100s,
# 93.5% of f64 rows agreed to 1e-6 after 20 ticks, with a median of 5.5e-14
# (these thresholds were set after that run). So: the psum statistics equal
# the per-row sums exactly, the median row agrees to FOUR_MEDIAN, and at
# least FOUR_FRAC of the rows agree to FOUR_ATOL. Broken sharding (rows on
# the wrong card, a lost shard) moves nearly every row.
FOUR_B, FOUR_ATOL, FOUR_FRAC, FOUR_MEDIAN = 4 * 1024, 1e-6, 0.9, 1e-9


def phase_four():
    import jax

    with jax.enable_x64(True):
        _four_cards()


def _four_cards():
    import jax
    import jax.numpy as jnp

    from doa_mpc_tpu.parallel.mesh import (
        make_data_mesh, make_sharded_rollout, shard_leading_axis)
    from doa_mpc_tpu.sim.closed_loop import make_batched_rollout, metrics_of

    devices = jax.devices()
    if len(devices) != 4:
        raise AssertionError(f"--four needs 4 GPUs, found {len(devices)}")
    ctrl, params, start, goal = _controller(N=20, M=5, qp_iter=20, tf=2.0,
                                            dtype=np.float64)
    B = FOUR_B
    roll = make_batched_rollout(ctrl, goal, params, max_iter=20)
    with jax.default_device(devices[0]):
        st = _init(ctrl, start, goal, "RANDOM", B)
        ref = jax.block_until_ready(jax.jit(roll)(st))
    mesh = make_data_mesh(devices)
    sharded = shard_leading_axis(st, mesh)
    t0 = time.perf_counter()
    final, stats = jax.block_until_ready(
        jax.jit(make_sharded_rollout(roll, mesh))(sharded))
    log(f"[e] sharded {B} scenarios x 20 ticks over 4 GPUs, f64: "
        f"{time.perf_counter() - t0:.1f} s incl. compile")
    placed = {s.device for s in final.x0.addressable_shards}
    if len(placed) != 4:
        raise AssertionError(f"state on {len(placed)} devices, not 4")
    m = jax.vmap(metrics_of)(final)
    for key in ("reached", "hit", "oob", "steps"):
        want = float(jnp.sum(getattr(m, key).astype(jnp.float32)))
        got = float(stats["steps_sum" if key == "steps" else key])
        log(f"[e] psum {key} {got} vs per-row sum {want}")
        if got != want:
            raise AssertionError(f"psum {key} differs from the row sum")
    if float(stats["n"]) != B:
        raise AssertionError("psum n differs from the row count")
    dev = np.abs(np.asarray(final.x0) - np.asarray(ref.x0)).max(axis=1)
    frac = float(np.mean(dev <= FOUR_ATOL))
    log(f"[e] per-row max |x_sharded - x_card0| after 20 ticks: median "
        f"{np.median(dev):.2e}, max {dev.max():.2e}, {frac:.2%} of rows "
        f"within {FOUR_ATOL} (need {FOUR_FRAC:.0%}, median <= "
        f"{FOUR_MEDIAN})")
    if not (frac >= FOUR_FRAC and np.median(dev) <= FOUR_MEDIAN):
        raise AssertionError("sharded rows differ from the one-card run")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded phase")
    ap.add_argument("--cpu-reference", nargs=4,
                    metavar=("SCENARIO", "RUNS", "TICKS", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_reference:
        cpu_reference(*args.cpu_reference)
        return 0

    from doa_mpc_tpu.utils.compile_cache import enable_compile_cache

    device = phase_device()
    enable_compile_cache()

    def run(phase, *a):
        t0 = time.perf_counter()
        out = phase(*a)
        log(f"# {phase.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    if args.four:
        run(phase_four)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            refs = start_cpu_references(tmp)
            try:
                gpu_rates = run(phase_experiment)
                run(phase_fleet_tick)
                run(phase_numerics)
                run(phase_experiment_rates, gpu_rates, refs)
            finally:
                for proc, _ in refs.values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
