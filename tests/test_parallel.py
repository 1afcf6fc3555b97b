"""Mesh-sharded Monte-Carlo tests on the 8-virtual-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp

from doa_mpc_tpu.config import WorldSpec, SolverOptions, default_cost_params
from doa_mpc_tpu.parallel.mesh import (
    make_data_mesh, make_sharded_rollout, shard_leading_axis,
)
from doa_mpc_tpu.sim.closed_loop import init_loop_state, make_rollout, metrics_of
from doa_mpc_tpu.sim.obstacles import robot_start_goal
from doa_mpc_tpu.solver.sqp_rti import make_rti_controller

SPEC = WorldSpec(tf=1.0, n_solv=5, qp_iter=8)
OPTS = SolverOptions(qp_iter=8, integrator="rk4")


def _batched_state(ctrl, B, dtype=jnp.float64):
    start, goal = robot_start_goal(SPEC)
    start, goal = start.astype(dtype), goal.astype(dtype)
    st = init_loop_state(jax.random.PRNGKey(0), ctrl, start, goal,
                         "RANDOM", batch_shape=(B,))
    return st, goal


def test_eight_device_mesh_available():
    assert len(jax.devices()) == 8


def test_sharded_rollout_matches_unsharded():
    ctrl = make_rti_controller(SPEC, OPTS, dtype=jnp.float64)
    params = default_cost_params(SPEC, dtype=jnp.float64)
    B = 16
    st, goal = _batched_state(ctrl, B)
    rollout = make_rollout(ctrl, goal, params, max_iter=15)

    # unsharded reference
    ref_final = jax.jit(jax.vmap(rollout))(st)
    ref_m = jax.vmap(metrics_of)(ref_final)

    mesh = make_data_mesh()
    st_sharded = shard_leading_axis(st, mesh)
    fn = jax.jit(make_sharded_rollout(jax.vmap(rollout), mesh))
    final, stats = fn(st_sharded)
    m = jax.vmap(metrics_of)(final)

    np.testing.assert_allclose(np.asarray(m.dist), np.asarray(ref_m.dist),
                               atol=1e-10)
    np.testing.assert_array_equal(np.asarray(m.steps), np.asarray(ref_m.steps))
    assert float(stats["n"]) == B
    assert float(stats["reached"]) == float(jnp.sum(ref_m.reached))
    assert float(stats["hit"]) == float(jnp.sum(ref_m.hit))
    np.testing.assert_allclose(float(stats["min_margin"]),
                               float(jnp.min(ref_m.min_margin)), rtol=1e-6)


def test_sharded_state_layout():
    ctrl = make_rti_controller(SPEC, OPTS, dtype=jnp.float64)
    st, _ = _batched_state(ctrl, 16)
    mesh = make_data_mesh()
    sharded = shard_leading_axis(st, mesh)
    shard_counts = {len(x.addressable_shards) for x in jax.tree.leaves(sharded)}
    assert shard_counts == {8}


def test_solver_under_shard_map_matches_unsharded():
    """The batched f32 interior point composes with ``shard_map`` over the
    8-device mesh: each device solves its own shard, and the rows equal the
    unsharded solve (the four-GPU run is ``chip_smoke.py --four``)."""
    import os
    import sys
    from functools import partial

    from jax.sharding import PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_ip_qp import _make_qp
    from doa_mpc_tpu.ops.ip_qp import solve_ocp_qp

    B = 16
    rng = np.random.default_rng(0)
    qps = [_make_qp(rng, N=3, M=2) for _ in range(B)]
    qp = jax.tree.map(
        lambda *a: jnp.stack([jnp.asarray(x, jnp.float32) for x in a]), *qps)
    mesh = make_data_mesh(jax.devices())
    qp_sh = shard_leading_axis(qp, mesh)

    @partial(jax.shard_map, mesh=mesh, in_specs=(P("data"),),
             out_specs=P("data"), check_vma=False)
    def solve(q):
        return solve_ocp_qp(q, iters=2).du

    du = jax.jit(solve)(qp_sh)
    assert len(du.addressable_shards) == 8
    ref = solve_ocp_qp(qp, iters=2)
    np.testing.assert_allclose(np.asarray(du), np.asarray(ref.du),
                               atol=5e-6)
