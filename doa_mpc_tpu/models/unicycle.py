"""Unicycle robot model and obstacle-distance constraints.

JAX replacement for the CasADi symbolic model of
``/root/reference/src/models/robot_model.py:8-67``: instead of building an SX
graph and C-code-generating it through acados, the dynamics are a plain JAX
function; Jacobians/sensitivities come from ``jax.jacfwd`` at trace time and
fuse into the surrounding kernels.

State  s = (x, y, psi, v, omega)          (robot_model.py:14-22)
Control u = (u_a, u_alpha)                (robot_model.py:25-27)
Dynamics (robot_model.py:39-43):
    x'     = v * cos(psi)
    y'     = v * sin(psi)
    psi'   = omega
    v'     = u_a
    omega' = u_alpha

Obstacle constraint (robot_model.py:60-65), one row per obstacle i with
per-stage parameters p in R^{2*M} holding obstacle centers:
    h_i(s, p) = (x - p_x_i)^2 + (y - p_y_i)^2 - (R_OBST + R_ROBOT + MARGIN)^2 >= 0
"""

from __future__ import annotations

import jax.numpy as jnp

# The safe squared distance is (r_obst + r_robot + margin)^2; which WorldSpec
# fields feed it (documented for callers assembling it from a spec).
SAFE_DIST_SQ_FIELDS = ("r_obst", "r_robot", "margin")


def dynamics(s: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Continuous-time unicycle dynamics f(s, u) -> ds/dt.

    Shapes: ``s`` (..., 5), ``u`` (..., 2) -> (..., 5). Broadcasts over any
    leading batch dims, so the same function serves single-scenario tests and
    the 4096-wide production batch.
    """
    v = s[..., 3]
    psi = s[..., 2]
    return jnp.stack(
        [
            v * jnp.cos(psi),
            v * jnp.sin(psi),
            s[..., 4],
            u[..., 0],
            u[..., 1],
        ],
        axis=-1,
    )


def safe_dist_sq(spec) -> float:
    """(R_OBST + R_ROBOT + MARGIN)^2 from robot_model.py:63."""
    return (spec.r_obst + spec.r_robot + spec.margin) ** 2


def obstacle_h(s: jnp.ndarray, p: jnp.ndarray, safe_sq) -> jnp.ndarray:
    """Constraint values h(s, p) >= 0, one per obstacle.

    ``s`` (..., 5), ``p`` (..., M, 2) obstacle centers -> (..., M).
    """
    d = s[..., None, 0:2] - p
    return jnp.sum(d * d, axis=-1) - safe_sq


def obstacle_h_jac(s: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Jacobian dh/ds, shape (..., M, 5).

    h_i depends only on (x, y): dh_i/d(x,y) = 2*((x,y) - p_i); the analytic
    form is used instead of jacfwd because it is the hot path's only
    constraint Jacobian and the closed form keeps the kernel lean.
    """
    d = s[..., None, 0:2] - p                      # (..., M, 2)
    zeros = jnp.zeros(d.shape[:-1] + (3,), d.dtype)
    return jnp.concatenate([2.0 * d, zeros], axis=-1)
