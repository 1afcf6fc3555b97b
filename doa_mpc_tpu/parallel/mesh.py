"""Scenario data-parallelism over a device mesh.

The reference runs its 100-seed Monte-Carlo serially in one process
(``/root/reference/src/simulation/experiments.py:32-36``) and "scales" by
re-executing itself via ``os.system`` (``run_multiple_experiments.py:21``).
Here the scenario axis is a sharded batch dimension:

- one 1-D mesh axis ``"data"`` over the devices (the four GPUs of one host
  are joined all to all by NVLink, so the mesh follows the algorithm, not
  the wiring; across hosts the same axis spans the network),
- scenario batches live sharded across it (`NamedSharding(P("data"))`),
- the whole closed-loop rollout runs under ``shard_map``; each device scans
  its local scenarios in lockstep,
- Monte-Carlo aggregates (collision / goal-reached counts, the
  ``evaluate_experiments.py:21-33`` statistics) are reduced with ``psum``
  over the mesh so every host sees the global rates.

Per-problem tensor parallelism is pointless at nx=5 (SURVEY.md section 2.3);
all parallelism is batch. The same code path drives 8 virtual CPU devices in
tests and the GPUs of one or more hosts in production — only the mesh
differs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from doa_mpc_tpu.sim.closed_loop import LoopMetrics, metrics_of


def make_data_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices, axis name ``data``."""
    devices = jax.devices() if devices is None else devices
    import numpy as np
    return Mesh(np.asarray(devices), axis_names=("data",))


def shard_leading_axis(tree, mesh: Mesh):
    """Place every array in ``tree`` with its leading axis split over
    ``data`` (scenario sharding)."""
    sharding = NamedSharding(mesh, P("data"))

    def put(x):
        return jax.device_put(x, sharding)

    return jax.tree.map(put, tree)


def make_sharded_rollout(batched_rollout, mesh: Mesh):
    """Wrap a *batched* rollout into a mesh-sharded run.

    ``batched_rollout`` operates on a batch of scenarios (e.g.
    ``sim.closed_loop.make_batched_rollout`` or ``jax.vmap`` of a
    single-scenario rollout).
    Each device runs it on its local scenario shard.

    Returns ``fn(batched_state) -> (final_state, global_stats)`` where
    ``global_stats`` is a dict of psum-reduced Monte-Carlo aggregates
    (the evaluate_experiments.py:21-33 rates, computed on-device instead of
    from CSVs). The final state stays sharded; the stats are replicated.
    """

    @partial(shard_map, mesh=mesh, in_specs=(P("data"),),
             out_specs=(P("data"), P()), check_vma=False)
    def fn(batched_state):
        final = batched_rollout(batched_state)
        m: LoopMetrics = jax.vmap(metrics_of)(final)
        local_n = m.reached.shape[0]
        stats = {
            "n": jax.lax.psum(jnp.asarray(local_n, jnp.float32), "data"),
            "reached": jax.lax.psum(jnp.sum(m.reached.astype(jnp.float32)), "data"),
            "hit": jax.lax.psum(jnp.sum(m.hit.astype(jnp.float32)), "data"),
            "oob": jax.lax.psum(jnp.sum(m.oob.astype(jnp.float32)), "data"),
            "steps_sum": jax.lax.psum(jnp.sum(m.steps.astype(jnp.float32)), "data"),
            "min_margin": jax.lax.pmin(jnp.min(m.min_margin.astype(jnp.float32)), "data"),
        }
        return final, stats

    return fn
