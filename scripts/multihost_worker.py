"""One process of a multi-process CPU job (driven by tests/test_multihost.py).

Usage:
    python scripts/multihost_worker.py PID NPROC PORT OUT_CSV DEV_PER_PROC

Joins a NPROC-process distributed runtime at localhost:PORT with
DEV_PER_PROC virtual CPU devices per process, runs the batched closed loop
over the global ("data",) mesh with per-host scenario shards
(parallel/distributed.py), and — on host 0 only — writes the gathered
per-row metrics to OUT_CSV. The same script with NPROC=1, DEV_PER_PROC=8
produces the single-process baseline the test compares against.
"""

import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
out_csv, dev_per_proc = sys.argv[4], int(sys.argv[5])

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + f" --xla_force_host_platform_device_count={dev_per_proc}")
sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import numpy as np
import jax

from doa_mpc_tpu.config import SolverOptions, WorldSpec
from doa_mpc_tpu.parallel.distributed import initialize, is_host0
from doa_mpc_tpu.parallel.mesh import make_data_mesh
from doa_mpc_tpu.sim.experiments import run_scenario_batch

if nproc > 1:
    initialize(coordinator_address=f"localhost:{port}",
               num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert jax.device_count() == nproc * dev_per_proc, jax.device_count()

spec = WorldSpec(tf=0.5, n_solv=5, n_obst=3, qp_iter=4)
opts = SolverOptions(qp_iter=4, integrator="rk4")
mesh = make_data_mesh()

data = run_scenario_batch(spec, opts, "RANDOM", n_runs=16, max_iter=6,
                          mesh=mesh)
if is_host0():
    np.savetxt(out_csv, data, delimiter=";")
    print("host0 wrote", out_csv, "rows", data.shape[0], flush=True)
