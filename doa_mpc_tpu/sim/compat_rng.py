"""Bit-exact reproduction of the reference's MT19937 random streams.

The reference seeds numpy's global legacy RandomState once per experiment
(``np.random.seed(i)``, /root/reference/src/simulation/experiments.py:33) and
then draws, in this exact order:

1. obstacle placement — ``np.random.uniform(X_MIN_OBST, X_MAX_OBST, (M, 1))``
   for x, then y, then ``uniform(-V_MAX_OBST, V_MAX_OBST, (M, 1))`` for vx,
   then vy (obstacle_generator.py:11-22; CENTER/EDGE skip the two position
   draws);
2. per executed control tick, for each obstacle in list order,
   ``np.random.normal(size=2)`` velocity noise (visualization.py:31, called
   from robot_ocp_problem.py:217-218).

This module regenerates those streams on the host with
``np.random.RandomState(seed)`` — the same MT19937 + legacy
uniform/gauss transforms — so a device rollout can consume the *identical*
obstacle worlds and noise realizations seed-for-seed. numpy's legacy
gaussian cache lives in the RandomState, so drawing ``normal(size=(T, M, 2))``
in one call yields the same C-ordered sequence as the reference's per-tick
``size=2`` calls.

Runs that reach the goal before ``max_iter`` simply never consume the tail
of the precomputed stream, matching the reference's early ``break``
(robot_ocp_problem.py:249-250) followed by a fresh ``np.random.seed`` for
the next experiment.
"""

from __future__ import annotations

import numpy as np

from doa_mpc_tpu.sim.obstacles import ObstacleState


def mt_experiment_streams(seed: int, spec, scenario: str = "RANDOM",
                          max_iter: int = 400, dtype=np.float32):
    """MT19937 streams for one seeded experiment.

    Returns ``(obst, noise)`` where ``obst`` is the initial
    :class:`ObstacleState` ((M, 2) pos / vel as numpy arrays) and ``noise``
    is the ``(max_iter, M, 2)`` standard-normal velocity-noise stream, all
    drawn in the reference's order (module docstring).
    """
    rs = np.random.RandomState(seed)
    m = spec.n_obst
    xlo, xhi, ylo, yhi = spec.obst_box
    if scenario == "RANDOM":
        x = rs.uniform(xlo, xhi, (m, 1))
        y = rs.uniform(ylo, yhi, (m, 1))
    elif scenario == "CENTER":
        x = np.zeros((m, 1))
        y = np.zeros((m, 1))
    elif scenario == "EDGE":
        x = 7.0 * np.ones((m, 1))
        y = 7.0 * np.ones((m, 1))
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    v = spec.v_max_obst
    vx = rs.uniform(-v, v, (m, 1))
    vy = rs.uniform(-v, v, (m, 1))
    pos = np.hstack([x, y]).astype(dtype)
    vel = np.hstack([vx, vy]).astype(dtype)
    noise = rs.normal(size=(max_iter, m, 2)).astype(dtype)
    return ObstacleState(pos=pos, vel=vel), noise


def mt_experiment_batch(seeds, spec, scenario: str = "RANDOM",
                        max_iter: int = 400, dtype=np.float32):
    """Streams for a batch of seeds, stacked for the batched rollout.

    Returns ``(obst, noise)`` with ``obst`` pos/vel of shape (B, M, 2) and
    ``noise`` of shape (max_iter, B, M, 2) — the scan-major layout
    ``make_batched_rollout`` consumes as per-tick xs.
    """
    obsts, noises = zip(*(mt_experiment_streams(int(s), spec, scenario,
                                                max_iter, dtype)
                          for s in seeds))
    pos = np.stack([o.pos for o in obsts])
    vel = np.stack([o.vel for o in obsts])
    noise = np.stack(noises, axis=1)
    return ObstacleState(pos=pos, vel=vel), noise
