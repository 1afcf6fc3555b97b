"""Profiling utilities: FLOP model sanity + timing helper."""

import jax.numpy as jnp
import pytest

from doa_mpc_tpu.config import WorldSpec
from doa_mpc_tpu.utils.profiling import (
    device_peaks, speed_of_light_report, tick_flops, time_fn, Timer,
)


def test_tick_flops_scales():
    spec = WorldSpec(tf=2.0, n_solv=20)
    f1 = tick_flops(spec, qp_iter=20, batch=1)
    f2 = tick_flops(spec, qp_iter=20, batch=4096)
    assert f2["per_tick_flops"] == 4096 * f1["per_tick_flops"]
    f3 = tick_flops(spec, qp_iter=40, batch=1)
    assert f3["per_scenario_flops"] > 1.8 * f1["per_scenario_flops"]


H100 = "NVIDIA H100 80GB HBM3"


def test_speed_of_light_report_fields():
    spec = WorldSpec(tf=2.0, n_solv=20)
    rep = speed_of_light_report(spec, qp_iter=6, batch=4096,
                                measured_tick_s=1e-3, device_kind=H100)
    assert rep["achieved_flops"] > 0
    assert 0 < rep["roofline_share"] < 1
    assert rep["bound"] in ("flops", "memory")
    assert rep["hbm_bound_tick_s"] > 0
    assert rep["roofline_share"] == max(
        rep["flop_bound_tick_s"], rep["hbm_bound_tick_s"]) / 1e-3
    # the XLA interior point re-reads its QP data every iteration
    rep2 = speed_of_light_report(spec, qp_iter=12, batch=4096,
                                 measured_tick_s=1e-3, device_kind=H100)
    assert rep2["hbm_bytes"] == 2 * rep["hbm_bytes"]


def test_peak_table_refuses_unknown_device():
    assert device_peaks(H100)["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks("Unknown Accelerator")
    with pytest.raises(ValueError):
        speed_of_light_report(WorldSpec(), qp_iter=6, batch=1,
                              measured_tick_s=1e-3, device_kind="cpu")


def test_time_fn_runs():
    def step(x):
        return x * 1.000001 + 1e-6

    dt = time_fn(step, jnp.ones((64,)), reps=3)
    assert dt >= 0


def test_timer_sections():
    t = Timer()
    with t.section("a"):
        sum(range(1000))
    with t.section("a"):
        sum(range(1000))
    assert t.sections["a"] > 0
