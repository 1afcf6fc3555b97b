"""Real multi-process orchestration test (SURVEY.md section 2.3, multi-host).

Launches an actual 2-process x 4-virtual-device CPU job (each process is a
separate Python interpreter joining a jax.distributed coordination service)
and checks that its global per-row metrics are identical to the 1-process x
8-device run of the same global batch — the SPMD program must not care how
the 8 devices are split across processes. Also covers: per-host shard
construction (``make_global_batch``), metric all-gather (``gather_rows``),
and host-0-only artifact IO.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _clean_env():
    env = dict(os.environ)
    # the workers pick their own platform/device-count flags
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


def _run_workers(nproc, dev_per_proc, out_csv, timeout=600):
    port = _free_port()
    env = _clean_env()
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nproc), str(port),
             out_csv, str(dev_per_proc)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
    return outs


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost")
    csv1 = str(d / "single.csv")
    csv2 = str(d / "two_proc.csv")
    _run_workers(1, 8, csv1)
    outs2 = _run_workers(2, 4, csv2)
    return csv1, csv2, outs2


def test_two_process_matches_single_process(jobs):
    csv1, csv2, _ = jobs
    a = np.loadtxt(csv1, delimiter=";")
    b = np.loadtxt(csv2, delimiter=";")
    assert a.shape == b.shape == (16, 6)
    # identical math, identical global batch -> identical metrics
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    # boolean/count columns must agree exactly
    np.testing.assert_array_equal(a[:, [0, 1, 4, 5]], b[:, [0, 1, 4, 5]])


def test_host0_only_io(jobs):
    """Only process 0 writes (and reports writing) the artifact."""
    csv1, csv2, outs2 = jobs
    assert os.path.exists(csv2)
    assert sum("host0 wrote" in o for o in outs2) == 1


def test_cli_distributed_two_processes(tmp_path):
    """The production CLI path: 2 processes run
    ``python -m doa_mpc_tpu experiment --distributed`` against one
    coordinator; host 0 alone writes the artifacts and prints the summary."""
    port = _free_port()
    out_dir = str(tmp_path / "cli_out")
    procs, outs = [], []
    for pid in range(2):
        env = _clean_env()
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            "JAX_COORDINATOR_ADDRESS": f"localhost:{port}",
            "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(pid),
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "doa_mpc_tpu", "experiment",
             "--distributed", "--runs", "16",
             "--max-iter", "6", "--tf", "0.5", "--n-solv", "5",
             "--n-obst", "3", "--qp-iter", "4",
             "--scenarios", "RANDOM", "--out", out_dir],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"CLI worker failed:\n{out}"
    csvs = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
    assert len(csvs) == 1, csvs
    data = np.loadtxt(os.path.join(out_dir, csvs[0]), delimiter=";")
    assert data.shape == (16, 6)
    # host-0-only verbosity: exactly one process printed the summary line
    assert sum("collision=" in o for o in outs) == 1
