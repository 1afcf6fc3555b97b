"""Vectorized obstacle world.

Batched JAX replacement for the reference ``Obstacle`` class
(``/root/reference/src/utils/visualization.py:10-85``) and the scenario
generator (``src/utils/obstacle_generator.py:8-28``). The reference steps a
Python list of obstacle objects one at a time; here the whole world is a
single array ``(..., M, 4)`` of (x, y, vx, vy) rows advanced in one fused
kernel, batched over scenarios.

Semantics reproduced exactly:

- **Wall bounce** (visualization.py:35-60): per axis, compute time-to-wall
  ``t_hit``; if ``t_hit <= dt`` the obstacle travels to the wall and reflects
  for the remaining time, and its velocity flips sign.
- **Motion noise** (visualization.py:28-33): with ``random_move``, each step
  scales each velocity component by ``(1 + RANDOMNESS * N(0,1))`` and clamps
  to +-V_MAX_OBST *before* the bounce integration.
- **Prediction** (visualization.py:62-79): ``predict_trajectory`` rolls n
  noise-free bounce steps from the current state. The reference has a bug at
  visualization.py:69 — it seeds the prediction with ``vx = self.vy`` — which
  we fix by default and reproduce behind ``compat_pred_bug`` for
  apples-to-apples evaluation runs.
- **Scenarios** (obstacle_generator.py:10-22): RANDOM places obstacles
  uniformly in the obstacle box, CENTER at the origin, EDGE at (7, 7);
  velocities are uniform in +-V_MAX_OBST in all scenarios.

RNG: ``jax.random`` keys instead of the global ``np.random.seed(i)`` calls at
``experiments.py:33`` — each scenario row carries its own fold of the seed.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

SCENARIOS = ("RANDOM", "CENTER", "EDGE")


class ObstacleState(NamedTuple):
    """World state: positions (..., M, 2) and velocities (..., M, 2)."""

    pos: jnp.ndarray
    vel: jnp.ndarray


def generate_obstacles(key, spec, scenario: str, batch_shape=(),
                       dtype=jnp.float32) -> ObstacleState:
    """Sample an obstacle world per ``obstacle_generator.py:8-28``.

    ``scenario`` is one of RANDOM / CENTER / EDGE. Positions for CENTER/EDGE
    are deterministic; velocities are always uniform in +-v_max_obst.
    """
    kx, ky, kvx, kvy = jax.random.split(key, 4)
    m = spec.n_obst
    shape = tuple(batch_shape) + (m,)
    lo, hi, _, _ = spec.obst_box
    if scenario == "RANDOM":
        x = jax.random.uniform(kx, shape, minval=lo, maxval=hi, dtype=dtype)
        y = jax.random.uniform(ky, shape, minval=lo, maxval=hi, dtype=dtype)
    elif scenario == "CENTER":
        x = jnp.zeros(shape, dtype)
        y = jnp.zeros(shape, dtype)
    elif scenario == "EDGE":
        x = jnp.full(shape, 7.0, dtype)
        y = jnp.full(shape, 7.0, dtype)
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    v = spec.v_max_obst
    vx = jax.random.uniform(kvx, shape, minval=-v, maxval=v, dtype=dtype)
    vy = jax.random.uniform(kvy, shape, minval=-v, maxval=v, dtype=dtype)
    return ObstacleState(pos=jnp.stack([x, y], -1), vel=jnp.stack([vx, vy], -1))


def _bounce_axis(p, v, dt, lo, hi):
    """One axis of the exact wall-reflection step (visualization.py:35-60)."""
    avs = jnp.abs(v)
    t_hit = jnp.where(
        v < 0, (p - lo) / jnp.maximum(avs, 1e-30),
        jnp.where(v > 0, (hi - p) / jnp.maximum(avs, 1e-30), jnp.inf),
    )
    hit = t_hit <= dt
    p_new = jnp.where(hit, p + v * t_hit - v * (dt - t_hit), p + v * dt)
    v_new = jnp.where(hit, -v, v)
    return p_new, v_new


def bounce_step(state: ObstacleState, spec, dt=None) -> ObstacleState:
    """Noise-free constant-velocity step with wall reflection."""
    dt = spec.dt if dt is None else dt
    px, vx = _bounce_axis(state.pos[..., 0], state.vel[..., 0], dt, spec.x_min, spec.x_max)
    py, vy = _bounce_axis(state.pos[..., 1], state.vel[..., 1], dt, spec.y_min, spec.y_max)
    return ObstacleState(jnp.stack([px, py], -1), jnp.stack([vx, vy], -1))


def obstacle_step(key, state: ObstacleState, spec, random_move: bool = True,
                  noise=None) -> ObstacleState:
    """Simulation step: optional velocity noise, then bounce (visualization.py:20-33).

    Noise scales each velocity component by (1 + randomness * N(0,1)) and
    clamps to +-v_max_obst, matching the reference's per-obstacle
    ``np.random.normal(size=2)`` draw. Pass ``noise`` (same shape as vel) to
    use a precomputed standard-normal draw — the MT19937 compat mode
    (``sim/compat_rng.py``) feeds the reference's exact stream here.
    """
    if random_move:
        if noise is None:
            noise = jax.random.normal(key, state.vel.shape,
                                      dtype=state.vel.dtype)
        vel = (1.0 + spec.randomness * noise) * state.vel
        vel = jnp.clip(vel, -spec.v_max_obst, spec.v_max_obst)
        state = ObstacleState(state.pos, vel)
    return bounce_step(state, spec)


def predict_trajectory(state: ObstacleState, spec, n: int,
                       compat_pred_bug: bool = False) -> jnp.ndarray:
    """Noise-free n-step position forecast -> (n+1, ..., M, 2).

    Mirrors ``Obstacle.predict_trajectory`` (visualization.py:62-79): the
    first row is the current position, then n bounce steps. With
    ``compat_pred_bug`` the x-velocity is seeded from vy, reproducing the
    reference's line-69 typo (its published collision rates were produced
    with this bug in effect).

    Closed form instead of a scan: the reference's per-step reflection is
    exactly the continuous specular bounce sampled at k*dt (one wall hit per
    step at most, since v_max_obst*dt is far below the box size), and the
    specularly-reflected free path is the triangle-wave fold of
    ``p0 + v*t`` into the box. Evaluating the fold at all n+1 times at once
    replaces the 20-step sequential scan with one fused elementwise op —
    O(1) depth on the hot control-tick path. Equivalence to the step
    recursion is tested in tests/test_obstacles.py.
    """
    if compat_pred_bug:
        vel = jnp.stack([state.vel[..., 1], state.vel[..., 1]], -1)
        state = ObstacleState(state.pos, vel)

    dtype = state.pos.dtype
    t = (jnp.arange(n + 1, dtype=dtype) * spec.dt).reshape(
        (n + 1,) + (1,) * state.pos.ndim)
    lo = jnp.array([spec.x_min, spec.y_min], dtype)
    hi = jnp.array([spec.x_max, spec.y_max], dtype)
    period = 2.0 * (hi - lo)
    free = (state.pos - lo)[None] + t * state.vel[None]
    y = jnp.mod(free, period)
    return lo + jnp.minimum(y, period - y)


def _predict_trajectory_scan(state: ObstacleState, spec, n: int) -> jnp.ndarray:
    """Reference implementation of the forecast as n explicit bounce steps
    (the reference's loop at visualization.py:76-78); kept as the oracle for
    the closed-form fold above."""
    def step(s, _):
        s2 = bounce_step(s, spec)
        return s2, s2.pos

    _, future = jax.lax.scan(step, state, None, length=n)
    return jnp.concatenate([state.pos[None], future], axis=0)


def robot_start_goal(spec, margin: float = 1.0):
    """The canonical experiment start/goal (experiments.py:20):
    start (X_MIN+1, Y_MIN+1) heading pi/4, goal (X_MAX-1, Y_MAX-1).

    Host (numpy) arrays: they flow into jit closures (the tick factories),
    where they inline as constants."""
    import numpy as np

    start = np.array([spec.x_min + margin, spec.y_min + margin,
                      np.pi / 4, 0.0, 0.0])
    goal = np.array([spec.x_max - margin, spec.y_max - margin])
    return start, goal
