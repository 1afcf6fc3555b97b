"""Capture real closed-loop QPs that wedge the f32 XLA interior point.

Finds mid-rollout production QPs whose condensed Riccati overflows at the
sigma_max=1e7 clamp under reduced-precision reductions (about 1 in 256 on
the accelerator where it was first seen) and persists them as a regression
fixture for ``tests/test_sigma_retry.py::test_recorded_hard_qps_recover``.

Method: roll the production closed loop, and at every tick ALSO solve the
same QP batch with retry disabled. Rows whose final
duality measure stays near mu0=1.0 after the full iteration budget are
wedged; their QP data is appended to the fixture.

Usage: python scripts/capture_hard_qps.py [B] [ticks]
"""

import os
import sys
sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp

B = int(sys.argv[1]) if len(sys.argv) > 1 else 256
TICKS = int(sys.argv[2]) if len(sys.argv) > 2 else 120
ITERS = 20
WEDGE_MU = 0.5

from doa_mpc_tpu.config import SolverOptions, WorldSpec, default_cost_params
from doa_mpc_tpu.ops.ip_qp import solve_ocp_qp
from doa_mpc_tpu.ops.ocp_qp import OcpQp
from doa_mpc_tpu.sim.closed_loop import init_loop_state, make_batched_tick
from doa_mpc_tpu.sim.obstacles import predict_trajectory, robot_start_goal
from doa_mpc_tpu.solver.sqp_rti import make_rti_controller

dtype = jnp.float32
spec = WorldSpec(tf=2.0, n_solv=20, qp_iter=ITERS)
opts = SolverOptions(qp_iter=ITERS, integrator="rk4")
ctrl = make_rti_controller(spec, opts, dtype=dtype)
params = default_cost_params(spec, dtype=dtype)
start, goal = robot_start_goal(spec)
start, goal = start.astype(dtype), goal.astype(dtype)
st = init_loop_state(jax.random.PRNGKey(42), ctrl, start, goal, "RANDOM",
                     batch_shape=(B,))

tick = jax.jit(make_batched_tick(ctrl, goal, params))


@jax.jit
def build_and_probe(st):
    pred = predict_trajectory(st.obst, spec, spec.n_solv,
                              compat_pred_bug=opts.compat_pred_bug)
    pred = jnp.moveaxis(pred, 0, 1)
    qp = jax.vmap(
        lambda rti, x0, p: ctrl.build_qp(rti, x0, goal, p, params)
    )(st.rti, st.x0, pred)
    sol = solve_ocp_qp(qp, iters=ITERS, sigma_retry=0)
    return qp, sol.mu


hard = []
for t in range(TICKS):
    qp, mu = build_and_probe(st)
    mu = np.asarray(mu)
    wedged = np.nonzero(mu > WEDGE_MU)[0]
    for b in wedged:
        hard.append(jax.tree.map(lambda a, b=b: np.asarray(a[b]), qp))
        print(f"tick {t}: wedged row {b} mu={mu[b]:.3f}", flush=True)
    st = tick(st)

print(f"captured {len(hard)} wedged QPs over {TICKS} ticks x {B} rows",
      flush=True)
if hard:
    batch = jax.tree.map(lambda *ls: np.stack(ls), *hard)
    os.makedirs("tests/fixtures", exist_ok=True)
    out = {f: np.asarray(getattr(batch, f)) for f in OcpQp._fields}
    out["iters"] = np.asarray(ITERS)
    np.savez_compressed("tests/fixtures/hard_qps_f32.npz", **out)
    # sanity: with retry enabled they must recover
    qp = OcpQp(*[jnp.asarray(out[f]) for f in OcpQp._fields])
    rec = solve_ocp_qp(qp, iters=ITERS)
    print("with retry: mu max =", float(np.max(np.asarray(rec.mu))),
          flush=True)
else:
    print("no wedged rows observed (nothing to capture)", flush=True)
