"""Command-line interface.

Replaces the reference's process-spawning entry point
(``/root/reference/main.py:9-21``, which shells out via ``os.system`` —
and whose ``--multiple`` flag is dead because the code checks
``args.experiment``, main.py:10,19) with subcommands over the in-process
batched engine:

    python -m doa_mpc_tpu experiment   # the experiments.py Monte-Carlo
    python -m doa_mpc_tpu sweep        # TF x N_OBST grid (run_multiple_experiments)
    python -m doa_mpc_tpu qp-sweep     # QP_ITER sweep (run_experiments_qp_solver)
    python -m doa_mpc_tpu demo         # seeded visual runs -> GIF (demo.py)
    python -m doa_mpc_tpu sim          # open-loop integrator demo (robot_sim.py)
    python -m doa_mpc_tpu evaluate     # aggregate + plots (evaluate_experiments.py)
    python -m doa_mpc_tpu bench        # fleet throughput benchmark (GPU)
"""

from __future__ import annotations

import argparse


def _spec_args(p):
    p.add_argument("--tf", type=float, default=2.0)
    p.add_argument("--n-solv", type=int, default=20)
    p.add_argument("--n-obst", type=int, default=5)
    p.add_argument("--qp-iter", type=int, default=20)
    p.add_argument("--integrator", default="rk4", choices=["rk4", "irk"])
    p.add_argument("--f64", action="store_true")


def _mesh_args(p):
    p.add_argument("--distributed", action="store_true",
                   help="join a multi-process jax.distributed job (config "
                        "from JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / "
                        "JAX_PROCESS_ID or the cluster autodetect) and "
                        "shard the scenario batch over the global mesh; "
                        "host 0 writes the artifacts")
    p.add_argument("--mesh", action="store_true",
                   help="shard the scenario batch over the local devices "
                        "(single-process data parallelism); implied by "
                        "--distributed")


def _resolve_mesh(args):
    """Build the ("data",) device mesh requested by --distributed/--mesh.

    --distributed additionally joins the multi-process runtime first
    (parallel/distributed.initialize). Returns None when neither flag is
    set (plain single-device run).

    Launch recipe (one command per host):

        JAX_COORDINATOR_ADDRESS=host0:1234 JAX_NUM_PROCESSES=4 \
        JAX_PROCESS_ID=<i> python -m doa_mpc_tpu experiment --distributed ...
    """
    if not (getattr(args, "distributed", False)
            or getattr(args, "mesh", False)):
        return None
    if args.distributed:
        from doa_mpc_tpu.parallel.distributed import initialize
        initialize()
    from doa_mpc_tpu.parallel.mesh import make_data_mesh
    return make_data_mesh()


def _make(args):
    import jax.numpy as jnp
    from doa_mpc_tpu.config import SolverOptions, WorldSpec
    spec = WorldSpec(tf=args.tf, n_solv=args.n_solv, n_obst=args.n_obst,
                     qp_iter=args.qp_iter)
    opts = SolverOptions(qp_iter=args.qp_iter, integrator=args.integrator)
    dtype = jnp.float64 if args.f64 else jnp.float32
    return spec, opts, dtype


def main(argv=None):
    from doa_mpc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser(prog="doa_mpc_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("experiment", help="seeded Monte-Carlo (experiments.py)")
    _spec_args(p)
    p.add_argument("--runs", type=int, default=100)
    p.add_argument("--max-iter", type=int, default=400)
    p.add_argument("--out", default="test_data/new")
    p.add_argument("--scenarios", nargs="+", default=["RANDOM", "EDGE"])
    p.add_argument("--compat-rng", action="store_true",
                   help="replay the reference's exact MT19937 worlds and "
                        "obstacle noise per seed (np.random.seed(i) draw "
                        "order) — rows comparable 1:1 with its bundled CSVs")
    _mesh_args(p)

    p = sub.add_parser("sweep", help="TF x N_OBST sweep")
    p.add_argument("--runs", type=int, default=100)
    p.add_argument("--out", default="test_data/sweep")
    _mesh_args(p)

    p = sub.add_parser("qp-sweep", help="QP_ITER sweep")
    p.add_argument("--runs", type=int, default=100)
    p.add_argument("--out", default="test_data/qp_sweep")
    _mesh_args(p)

    p = sub.add_parser("demo", help="seeded visual run -> GIF (demo.py)")
    _spec_args(p)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--scenario", default="RANDOM")
    p.add_argument("--max-iter", type=int, default=400)
    p.add_argument("--gif", default="demo.gif")

    p = sub.add_parser("sim", help="open-loop integrator rollout (robot_sim.py)")
    p.add_argument("--steps", type=int, default=200)

    p = sub.add_parser("evaluate", help="aggregate rates + plots")
    p.add_argument("--data", default="test_data/new")
    p.add_argument("--out", default=".")
    p.add_argument("--qp", action="store_true",
                   help="QP_ITER plot instead of horizon plots")

    sub.add_parser("bench", help="fleet throughput benchmark (GPU)")

    args = parser.parse_args(argv)

    if args.cmd == "experiment":
        from doa_mpc_tpu.sim.experiments import run_experiment
        spec, opts, dtype = _make(args)
        run_experiment(spec=spec, opts=opts, scenarios=tuple(args.scenarios),
                       n_runs=args.runs, max_iter=args.max_iter,
                       out_dir=args.out, dtype=dtype, mesh=_resolve_mesh(args),
                       compat_rng=args.compat_rng)
    elif args.cmd == "sweep":
        from doa_mpc_tpu.sim.experiments import run_horizon_sweep
        run_horizon_sweep(n_runs=args.runs, out_dir=args.out, verbose=True,
                          mesh=_resolve_mesh(args))
    elif args.cmd == "qp-sweep":
        from doa_mpc_tpu.sim.experiments import run_qp_iter_sweep
        run_qp_iter_sweep(n_runs=args.runs, out_dir=args.out, verbose=True,
                          mesh=_resolve_mesh(args))
    elif args.cmd == "demo":
        _demo(args)
    elif args.cmd == "sim":
        _sim(args)
    elif args.cmd == "evaluate":
        from doa_mpc_tpu.sim.evaluate import (
            plot_graph, plot_graph_qp_solver, summarize)
        for row in summarize(args.data):
            print(row)
        if args.qp:
            plot_graph_qp_solver(args.data, args.out)
        else:
            plot_graph(args.data, args.out)
    elif args.cmd == "bench":
        import bench
        bench.main()


def _demo(args):
    """Seeded visual run (demo.py semantics, minus its bit-rotted seed arg)."""
    import jax
    from doa_mpc_tpu.config import default_cost_params
    from doa_mpc_tpu.sim.closed_loop import (
        init_loop_state, make_rollout, metrics_of)
    from doa_mpc_tpu.sim.obstacles import robot_start_goal
    from doa_mpc_tpu.solver.sqp_rti import make_rti_controller
    from doa_mpc_tpu.utils.viz import VisDynamicRobotEnv

    spec, opts, dtype = _make(args)
    ctrl = make_rti_controller(spec, opts, dtype=dtype)
    params = default_cost_params(spec, dtype=dtype)
    start, goal = robot_start_goal(spec)
    start, goal = start.astype(dtype), goal.astype(dtype)
    st = init_loop_state(jax.random.PRNGKey(args.seed), ctrl, start, goal,
                         args.scenario)
    rollout = jax.jit(make_rollout(ctrl, goal, params,
                                   max_iter=args.max_iter, collect=True))
    fin, (xs, obs, pred) = rollout(st)
    m = metrics_of(fin)
    print(f"reached={bool(m.reached)} hit={bool(m.hit)} "
          f"min_margin={float(m.min_margin):.3f} steps={int(m.steps)}")
    t = int(m.steps) + 1
    vis = VisDynamicRobotEnv(spec, xs[:t], obs[:t],
                             pred_traj=pred[:t, :, :2],
                             start=start, goal=goal)
    vis.save_animation(args.gif, every=2)
    print(f"wrote {args.gif}")


def _sim(args):
    """Open-loop IRK rollout (robot_sim.py:11-65): fixed control sequence,
    3-stage Radau IIA, printed trajectory."""
    import jax.numpy as jnp
    import numpy as np
    from doa_mpc_tpu.models.unicycle import dynamics
    from doa_mpc_tpu.ops.integrators import irk_step

    u_traj = np.zeros((args.steps, 2))
    u_traj[:10] = [1.0, 0.5]
    x = jnp.array([0.0, 0.0, np.pi / 4, 0.0, 0.0])
    xs = [np.asarray(x)]
    for i in range(args.steps):
        x = irk_step(dynamics, x, jnp.asarray(u_traj[i]), 0.1,
                     stages=3, newton_iter=3, tableau="radau_iia")
        xs.append(np.asarray(x))
    print(np.stack(xs)[:, :2])


if __name__ == "__main__":
    main()
