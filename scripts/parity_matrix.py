"""Full compat-mode parity matrix vs the reference's bundled baseline data.

Runs every configuration for which /root/reference/src/simulation/test_data/
has a (spec JSON, 100-seed CSV) pair — the reference's de-facto golden
baselines (SURVEY.md section 6) — through this framework's batched closed
loop with everything matched:

- compat_pred_bug=True (the reference's vx=vy prediction bug,
  visualization.py:69),
- init_guess_when_error=True with the plant-brake alias bug
  (robot_ocp_problem.py:203-205, 301-302) — ALL bundled runs have
  "init_guess": true,
- the interpolate-init guess for the two interpolate_init runs
  (test_data/20221031_2251*/2254*),
- IRK integrator (the reference's integrator_type='IRK'),
- the exact TF / N_SOLV / QP_ITER of each bundled spec.

Writes per-cell CSV+spec artifacts (reference schema) plus summary.json /
summary.md with our rates, the reference's rates, the gap, and the
Monte-Carlo standard error, under --out (default results/parity_r3).

Usage (GPU):
    python scripts/parity_matrix.py --runs 256
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REF_DATA = "/root/reference/src/simulation/test_data"


def load_reference_cells():
    """Read every bundled (spec, csv) pair into a list of cell dicts."""
    cells = []
    for spec_path in sorted(glob.glob(os.path.join(REF_DATA, "*_spec.json"))):
        with open(spec_path) as f:
            spec = json.load(f)
        csv_path = spec_path.replace("_experiment_spec.json",
                                     "_experiment_data.csv")
        data = np.loadtxt(csv_path, delimiter=";")
        cells.append({
            "stamp": os.path.basename(spec_path).split("_experiment")[0],
            "scenario": spec["scenario"],
            "tf": float(spec["TF"]),
            "n_solv": int(spec["N_SOLV"]),
            "n_obst": int(spec["N_OBST"]),
            "qp_iter": int(spec["QP_ITER"]),
            "interpolate": bool(spec.get("interpolate_init", False)),
            "ref_hit": float(data[:, 0].mean()),
            "ref_reached": float(data[:, 1].mean()),
            "ref_oob": float(data[:, 5].mean()),
            "ref_runs": int(data.shape[0]),
        })
    return cells


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=256)
    ap.add_argument("--max-iter", type=int, default=400)
    ap.add_argument("--integrator", default="irk", choices=["irk", "rk4"])
    ap.add_argument("--fail-mu", type=float, default=1e-7)
    ap.add_argument("--fail-stat", type=float, default=1e-4)
    ap.add_argument("--no-status4", action="store_true",
                    help="disable the status-4 reset analogue (ablation)")
    ap.add_argument("--no-brake", action="store_true",
                    help="reset warm start on failure but skip the plant-"
                         "velocity-zeroing alias bug (ablation)")
    ap.add_argument("--out", default="results/parity_r3")
    ap.add_argument("--only", default=None,
                    help="substring filter on cell stamp/scenario")
    args = ap.parse_args()

    import jax.numpy as jnp
    from doa_mpc_tpu.config import SolverOptions, WorldSpec
    from doa_mpc_tpu.sim.experiments import run_scenario_batch

    os.makedirs(args.out, exist_ok=True)
    cells = load_reference_cells()
    if args.only:
        cells = [c for c in cells
                 if args.only in c["stamp"] or args.only in c["scenario"]
                 or args.only == ("interp" if c["interpolate"] else "")]

    rows = []
    for c in cells:
        spec = WorldSpec(tf=c["tf"], n_solv=c["n_solv"], n_obst=c["n_obst"],
                         qp_iter=c["qp_iter"])
        opts = SolverOptions(
            qp_iter=c["qp_iter"], integrator=args.integrator,
            compat_pred_bug=True,
            init_guess_when_error=not args.no_status4,
            compat_brake_bug=not args.no_brake,
            fail_mu_tol=args.fail_mu, fail_stat_tol=args.fail_stat,
            init_guess="interpolate" if c["interpolate"] else "current")
        data, st = run_scenario_batch(
            spec, opts, c["scenario"], n_runs=args.runs,
            max_iter=args.max_iter, return_state=True)
        resets = np.asarray(st.resets)
        hit, reached, oob = (float(data[:, 0].mean()),
                             float(data[:, 1].mean()),
                             float(data[:, 5].mean()))
        # binomial stderr of the GAP between two independent rates
        se = float(np.sqrt(reached * (1 - reached) / args.runs
                           + c["ref_reached"] * (1 - c["ref_reached"])
                           / c["ref_runs"]))
        row = dict(c, hit=hit, reached=reached, oob=oob,
                   reached_gap=reached - c["ref_reached"],
                   hit_gap=hit - c["ref_hit"],
                   gap_stderr=se,
                   mean_resets=float(resets.mean()),
                   frac_rows_with_reset=float((resets > 0).mean()),
                   runs=args.runs)
        rows.append(row)
        print(f"{c['stamp']} {c['scenario']:6s} TF={c['tf']} "
              f"qp={c['qp_iter']:3d}{' interp' if c['interpolate'] else ''}"
              f" | ours hit/reach/oob {hit:.1%}/{reached:.1%}/{oob:.1%}"
              f" | ref {c['ref_hit']:.1%}/{c['ref_reached']:.1%}/"
              f"{c['ref_oob']:.1%} | reach gap {reached - c['ref_reached']:+.1%}"
              f" (+-{2 * se:.1%}) | resets mean {resets.mean():.1f}",
              flush=True)
        np.savetxt(os.path.join(
            args.out, f"{c['stamp']}_{c['scenario']}_ours.csv"),
            data, delimiter=";")

    # merge with any prior per-cell invocations (the matrix can be driven
    # one --only cell at a time)
    spath = os.path.join(args.out, "summary.json")
    merged = {}
    if os.path.exists(spath):
        with open(spath) as f:
            for r in json.load(f).get("cells", []):
                merged[(r["stamp"], r["scenario"])] = r
    for r in rows:
        merged[(r["stamp"], r["scenario"])] = r
    rows = sorted(merged.values(), key=lambda r: (r["stamp"], r["scenario"]))
    meta = {"runs": args.runs, "integrator": args.integrator,
            "status4": not args.no_status4, "brake": not args.no_brake,
            "fail_mu_tol": args.fail_mu, "fail_stat_tol": args.fail_stat,
            "compat_pred_bug": True, "cells": rows}
    with open(spath, "w") as f:
        json.dump(meta, f, indent=1)

    with open(os.path.join(args.out, "summary.md"), "w") as f:
        f.write("# Parity matrix vs reference bundled baselines\n\n")
        f.write(f"runs/cell={args.runs}, "
                f"integrator={args.integrator}, "
                f"status4={not args.no_status4}, brake={not args.no_brake}, "
                f"fail_tol=(mu {args.fail_mu}, stat {args.fail_stat})\n\n")
        f.write("| cell | scenario | TF | qp_iter | init | ours hit | "
                "ref hit | ours reached | ref reached | gap | 2*se | "
                "resets/run |\n|---|---|---|---|---|---|---|---|---|---|"
                "---|---|\n")
        for r in rows:
            f.write(f"| {r['stamp']} | {r['scenario']} | {r['tf']} | "
                    f"{r['qp_iter']} | "
                    f"{'interp' if r['interpolate'] else 'current'} | "
                    f"{r['hit']:.1%} | {r['ref_hit']:.1%} | "
                    f"{r['reached']:.1%} | {r['ref_reached']:.1%} | "
                    f"{r['reached_gap']:+.1%} | {2 * r['gap_stderr']:.1%} | "
                    f"{r['mean_resets']:.1f} |\n")
    print(f"wrote {args.out}/summary.json, summary.md")


if __name__ == "__main__":
    main()
