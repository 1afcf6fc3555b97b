"""What the program does around the solver: the GPU entry checks, the compile
cache, the matmul precision of the tick, the multi-device dry-run, and the
artifacts it builds or writes."""

import os

import jax
import numpy as np
import pytest


def test_chip_smoke_refuses_the_cpu():
    import chip_smoke

    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.check_device()


def test_chip_smoke_binomial_band():
    """The rate band of chip_smoke's CPU comparison: about three standard
    deviations of the difference of two binomial rates plus one row, and
    never zero at a rate of 0 or 1."""
    from chip_smoke import _binomial_band

    assert _binomial_band(0.5, 100) == pytest.approx(
        3 * np.sqrt(2 * 0.25 / 100) + 0.01)
    assert 0.01 < _binomial_band(0.0, 100) < 0.06
    assert _binomial_band(1.0, 100) == pytest.approx(_binomial_band(0.0, 100))


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_honours_environment(env_set, monkeypatch, tmp_path):
    from doa_mpc_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        if env_set:
            monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            # JAX reads the variable itself; nothing is set in code
            assert jax.config.jax_compilation_cache_dir is None
        else:
            monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
            path = compile_cache.enable_compile_cache()
            assert path == compile_cache.DEFAULT_DIR
            assert os.path.basename(path) == ".jax_cache"
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _dot_precisions(jaxpr):
    from jax._src import core

    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for p in eqn.params.values():
            sub = (p.jaxpr if isinstance(p, core.ClosedJaxpr)
                   else p if isinstance(p, core.Jaxpr) else None)
            if sub is not None:
                out += _dot_precisions(sub)
    return out


@pytest.mark.parametrize("integrator", ["rk4", "irk"])
def test_tick_runs_matmuls_at_full_precision(integrator):
    """Every f32 dot of the batched tick is traced at HIGHEST precision, so
    no accelerator runs it in a reduced-precision mode (TF32)."""
    import jax.numpy as jnp

    from doa_mpc_tpu.config import SolverOptions, WorldSpec, default_cost_params
    from doa_mpc_tpu.sim.closed_loop import init_loop_state, make_batched_tick
    from doa_mpc_tpu.sim.obstacles import robot_start_goal
    from doa_mpc_tpu.solver.sqp_rti import make_rti_controller

    spec = WorldSpec(tf=0.5, n_solv=5, n_obst=3, qp_iter=2)
    ctrl = make_rti_controller(
        spec, SolverOptions(qp_iter=2, integrator=integrator),
        dtype=jnp.float32)
    start, goal = robot_start_goal(spec)
    start, goal = start.astype(np.float32), goal.astype(np.float32)
    st = init_loop_state(jax.random.PRNGKey(0), ctrl, start, goal,
                         "RANDOM", batch_shape=(2,))
    tick = make_batched_tick(ctrl, goal,
                             default_cost_params(spec, dtype=jnp.float32))
    precisions = _dot_precisions(jax.make_jaxpr(tick)(st).jaxpr)
    assert precisions, "the tick traced no dot"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), set(map(str, precisions))


def test_dryrun_multichip_matches_unsharded():
    """The sharded production step on 4 of the 8 virtual CPU devices
    agrees with the unsharded tick, row by row and in its psum
    statistics (dryrun_multichip raises otherwise)."""
    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)


def test_experiment_stamps_stay_unique_within_a_second(tmp_path):
    from doa_mpc_tpu.sim.experiments import _unique_stamp

    seen = set()
    for _ in range(3):
        stamp = _unique_stamp(str(tmp_path))
        assert stamp not in seen
        seen.add(stamp)
        (tmp_path / f"{stamp}_experiment_data.csv").write_text("")


def test_native_library_is_built_not_committed():
    """The native oracle builds from source into the ignored build
    directory, and the build leaves no temporary file behind."""
    from doa_mpc_tpu import native

    if not native.available():
        pytest.skip("native toolchain unavailable")
    build = os.path.dirname(native._LIB_PATH)
    assert os.path.basename(build) == "build"
    assert os.path.exists(native._LIB_PATH)
    assert not [f for f in os.listdir(build) if f.endswith(".tmp")]
    repo = os.path.dirname(os.path.dirname(build))
    with open(os.path.join(repo, ".gitignore")) as f:
        assert "native/build/" in f.read().split()


@pytest.mark.gpu
def test_tick_on_gpu_matches_cpu(gpu):
    """On the card: three batched ticks agree with the same ticks on the
    CPU. Both run the same f32 program; the first ticks differ only in
    rounding (closed loops part later, on ill-conditioned rows)."""
    import jax.numpy as jnp

    from doa_mpc_tpu.config import SolverOptions, WorldSpec, default_cost_params
    from doa_mpc_tpu.sim.closed_loop import init_loop_state, make_batched_tick
    from doa_mpc_tpu.sim.obstacles import robot_start_goal
    from doa_mpc_tpu.solver.sqp_rti import make_rti_controller

    spec = WorldSpec(tf=2.0, n_solv=20, n_obst=5, qp_iter=20)
    ctrl = make_rti_controller(spec, SolverOptions(qp_iter=20),
                               dtype=jnp.float32)
    start, goal = robot_start_goal(spec)
    start, goal = start.astype(np.float32), goal.astype(np.float32)
    tick = jax.jit(make_batched_tick(
        ctrl, goal, default_cost_params(spec, dtype=jnp.float32)))
    finals = []
    for device in (gpu, jax.devices("cpu")[0]):
        with jax.default_device(device):
            st = init_loop_state(jax.random.PRNGKey(3), ctrl, start, goal,
                                 "EDGE", batch_shape=(64,))
            for _ in range(3):
                st = tick(st)
            finals.append(np.asarray(st.x0))
    dev = np.abs(finals[0] - finals[1]).max(axis=1)
    assert np.median(dev) < 1e-4
