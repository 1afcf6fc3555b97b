"""Performance accounting: FLOP and byte counts, device peaks, roofline.

The reference never measures anything (its one acados timing call is
commented out, ``robot_ocp_problem.py:262-263``). Here every hot component
has an analytic FLOP/byte model so a time measured on a device can be set
against that device's published peaks.
"""

from __future__ import annotations

import dataclasses
import time

import jax


# Published peaks per JAX ``device_kind``. Source: NVIDIA H100 Tensor Core
# GPU data sheet, SXM part: 67 TFLOP/s f32 outside the tensor cores (the
# interior point's 5x5 stage algebra is elementwise f32 work), 3.35 TB/s
# HBM3, 700 W board power at which those rates hold. A device missing here
# is an error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12, "power_w": 700.0},
}


def device_peaks(device_kind: str) -> dict:
    """Peak rates of the device named by JAX's ``device_kind``."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}") from None


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit`` per card, one line each)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def require_gpu() -> dict:
    """The default device's platform, kind and count, after checking that
    it is a GPU: a measurement that finds no GPU fails rather than
    reporting a CPU number."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"needs a GPU; JAX's default device is {dev.platform!r}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def tick_flops(spec, qp_iter: int, batch: int) -> dict:
    """Analytic FLOP model of one batched control tick.

    Components (per scenario):
      linearize : N stages x RK4-with-jacfwd  (~8 tangents x ~40 flops x 4)
      riccati   : per IP iteration, backward factorize ~ N x (4 matmuls
                  nx^3-ish + chol) + 2 back-substitutions
      ip_misc   : residuals/sigmas/steps over ~2(N+1)(nbx+M) + 2N*nu pairs
    """
    N, nx, nu, M = spec.n_solv, spec.nx, spec.nu, spec.n_obst
    lin = N * 8 * 40 * 4
    mm = 2 * nx * nx * nx
    fact = N * (4 * mm + 3 * nx * nu * nu + 20)
    solve = N * (4 * nx * nx + 6 * nx * nu)
    per_iter = fact + 2 * solve + 40 * (N + 1) * (2 * M + nx + nu)
    total = lin + qp_iter * per_iter
    return {
        "per_scenario_flops": total,
        "per_tick_flops": total * batch,
        "linearize_flops": lin * batch,
        "per_ip_iter_flops": per_iter * batch,
    }


def speed_of_light_report(spec, qp_iter: int, batch: int,
                          measured_tick_s: float, device_kind: str) -> dict:
    """Roofline accounting of one batched control tick on ``device_kind``.

    The least time the device could take is the larger of FLOPs over the
    f32 peak and bytes over the memory peak; ``roofline_share`` is that
    over the measured tick, and ``bound`` says which of the two sets it.
    The byte model assumes the XLA interior point rereads the QP data
    about twice per iteration.
    """
    peaks = device_peaks(device_kind)
    f = tick_flops(spec, qp_iter, batch)
    hbm_bytes = batch * 4 * (
        spec.n_solv * (2 * spec.nx * spec.nx + spec.nx * spec.nu
                       + spec.nx + spec.nu)
        + (spec.n_solv + 1) * (spec.n_obst * (spec.nx + 3) + 10))
    hbm_bytes *= 2 * qp_iter
    flop_time = f["per_tick_flops"] / peaks["f32_flops"]
    hbm_time = hbm_bytes / peaks["hbm_bytes_per_s"]
    return {
        **f,
        "device_kind": device_kind,
        "achieved_flops": f["per_tick_flops"] / measured_tick_s,
        "flop_bound_tick_s": flop_time,
        "hbm_bytes": hbm_bytes,
        "hbm_bound_tick_s": hbm_time,
        "bound": "flops" if flop_time >= hbm_time else "memory",
        "roofline_share": max(flop_time, hbm_time) / measured_tick_s,
        "measured_tick_s": measured_tick_s,
    }


def time_fn(fn, state0, reps: int = 10) -> float:
    """Median steady-state latency of jitted ``fn`` (state -> state), after
    one warm-up call that compiles it."""
    step = jax.jit(fn)
    state = jax.block_until_ready(step(state0))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = jax.block_until_ready(step(state))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


@dataclasses.dataclass
class Timer:
    """Accumulating section timer for host-side phases."""

    sections: dict = dataclasses.field(default_factory=dict)

    def section(self, name):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *a):
                timer.sections[name] = (timer.sections.get(name, 0.0)
                                        + time.perf_counter() - self.t0)

        return _Ctx()
