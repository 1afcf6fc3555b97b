"""doa_mpc_tpu — a batched, GPU-accelerated dynamic-obstacle-avoidance nonlinear-MPC
framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
abdelhakim96/Dynamic-Obstacle-Avoidance-MPC (reference mounted at
/root/reference): closed-loop real-time-iteration (RTI) nonlinear MPC for a
unicycle robot crossing a 16x16 grid world with moving circular obstacles.

Where the reference delegates its numerics to the acados C library
(CasADi codegen + IRK integration + SQP-RTI + partial condensing + HPIPM
interior-point QP), this framework is one SPMD program:

- dynamics + sensitivities  -> JAX autodiff through jitted integrators
  (``doa_mpc_tpu.ops.integrators``), replacing CasADi codegen,
- the OCP-structured QP     -> a batched primal-dual interior-point solver
  whose Newton systems are factorized by a block-tridiagonal Riccati sweep
  (``doa_mpc_tpu.ops``), replacing HPIPM/BLASFEO,
- the closed loop           -> a ``lax.scan`` rollout with masked
  per-scenario termination (``doa_mpc_tpu.sim.closed_loop``),
- the serial 100-seed Monte-Carlo loop (reference
  ``src/simulation/experiments.py:32-36``) -> a ``vmap``-batched,
  mesh-sharded scenario axis (``doa_mpc_tpu.parallel``).

Everything is batch-major: the per-problem matrices are tiny (nx=5, nu=2),
so throughput comes from thousands of scenarios solved in lockstep.
"""

__version__ = "0.1.0"

from doa_mpc_tpu.config import WorldSpec, CostParams, SolverOptions  # noqa: F401
