"""DDPG agent for MPC subgoal proposal.

The reference ships a DDPG *training loop* whose agent/env imports do not
exist in the repo (``/root/reference/src/train.py:3-7`` imports
``gym_examples...GridWorld`` and ``agent.ddpg_agent.DDPG`` — both missing;
SURVEY.md C12). This module supplies the working JAX agent the loop
was written for: actor/critic MLPs with the reference's [128, 128] hidden
layout (``train.py:27, 44-45``), target networks with polyak averaging,
a device-resident uniform replay buffer, and a fully jitted update step.

The actor emits a 2-D subgoal in grid coordinates (tanh squashed to the
robot box), consumed by the MPC closed loop through the subgoal interface —
the reference's ``set_subgoal(x, y)`` hook (robot_ocp_problem.py:279-284).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    obs_dim: int = 18          # 3 * (n_obst + 1), train.py:27
    act_dim: int = 2           # (x, y) subgoal, train.py:28
    hidden: tuple = (128, 128)  # train.py:44-45 defaults
    act_limit: float = 6.0     # subgoals within the robot box (+-6)
    gamma: float = 0.99        # train.py:48
    tau: float = 0.01          # soft target update, train.py:49 (tau)
    actor_lr: float = 1e-4     # train.py:42
    critic_lr: float = 1e-3    # train.py:43
    buffer_size: int = 100_000
    batch_size: int = 256
    noise_std: float = 0.1


class _MLP:
    """ReLU MLP with Dense layers initialized like ``flax.linen.Dense``
    (LeCun-normal weights, zero biases). Parameters are a list of
    ``{"w", "b"}`` dicts, one per layer."""

    def __init__(self, hidden: tuple, out_dim: int):
        self.sizes = tuple(hidden) + (out_dim,)

    def init(self, key, n_in: int, dtype=jnp.float32):
        params = []
        init_w = jax.nn.initializers.lecun_normal()
        for key, n_out in zip(jax.random.split(key, len(self.sizes)),
                              self.sizes):
            params.append({"w": init_w(key, (n_in, n_out), dtype),
                           "b": jnp.zeros((n_out,), dtype)})
            n_in = n_out
        return params

    def apply(self, params, x):
        for layer in params[:-1]:
            x = jax.nn.relu(x @ layer["w"] + layer["b"])
        return x @ params[-1]["w"] + params[-1]["b"]


class Actor:
    """Deterministic policy: obs -> act_limit * tanh(MLP(obs))."""

    def __init__(self, cfg: DDPGConfig):
        self.cfg = cfg
        self.mlp = _MLP(cfg.hidden, cfg.act_dim)

    def init(self, key, obs):
        return self.mlp.init(key, obs.shape[-1], obs.dtype)

    def apply(self, params, obs):
        return self.cfg.act_limit * jnp.tanh(self.mlp.apply(params, obs))


class Critic:
    """Action value: (obs, act) -> MLP([obs, act])."""

    def __init__(self, cfg: DDPGConfig):
        self.mlp = _MLP(cfg.hidden, 1)

    def init(self, key, obs, act):
        return self.mlp.init(key, obs.shape[-1] + act.shape[-1], obs.dtype)

    def apply(self, params, obs, act):
        x = jnp.concatenate([obs, act], axis=-1)
        return self.mlp.apply(params, x)[..., 0]


class Transition(NamedTuple):
    obs: jnp.ndarray
    act: jnp.ndarray
    rew: jnp.ndarray
    next_obs: jnp.ndarray
    done: jnp.ndarray


class ReplayBuffer(NamedTuple):
    """Device-resident ring buffer (no host roundtrips in the training loop)."""

    data: Transition
    ptr: jnp.ndarray
    size: jnp.ndarray

    @staticmethod
    def create(cfg: DDPGConfig, dtype=jnp.float32):
        n = cfg.buffer_size
        data = Transition(
            obs=jnp.zeros((n, cfg.obs_dim), dtype),
            act=jnp.zeros((n, cfg.act_dim), dtype),
            rew=jnp.zeros((n,), dtype),
            next_obs=jnp.zeros((n, cfg.obs_dim), dtype),
            done=jnp.zeros((n,), dtype),
        )
        return ReplayBuffer(data, jnp.zeros((), jnp.int32),
                            jnp.zeros((), jnp.int32))

    def add_batch(self, batch: Transition):
        n = self.data.obs.shape[0]
        b = batch.obs.shape[0]
        idx = (self.ptr + jnp.arange(b)) % n

        def put(buf, new):
            return buf.at[idx].set(new.astype(buf.dtype))

        data = jax.tree.map(put, self.data, batch)
        return ReplayBuffer(data, (self.ptr + b) % n,
                            jnp.minimum(self.size + b, n))

    def sample(self, key, batch_size: int) -> Transition:
        idx = jax.random.randint(key, (batch_size,), 0,
                                 jnp.maximum(self.size, 1))
        return jax.tree.map(lambda a: a[idx], self.data)


class AgentState(NamedTuple):
    actor: list
    critic: list
    actor_t: list
    critic_t: list
    opt_a: optax.OptState
    opt_c: optax.OptState


class DDPG:
    """Standard DDPG (Lillicrap et al. 2015) with jitted update."""

    def __init__(self, cfg: DDPGConfig):
        self.cfg = cfg
        self.actor = Actor(cfg)
        self.critic = Critic(cfg)
        self.opt_actor = optax.adam(cfg.actor_lr)
        self.opt_critic = optax.adam(cfg.critic_lr)

    def init(self, key) -> AgentState:
        ka, kc = jax.random.split(key)
        obs = jnp.zeros((1, self.cfg.obs_dim))
        act = jnp.zeros((1, self.cfg.act_dim))
        pa = self.actor.init(ka, obs)
        pc = self.critic.init(kc, obs, act)
        return AgentState(
            actor=pa, critic=pc, actor_t=pa, critic_t=pc,
            opt_a=self.opt_actor.init(pa), opt_c=self.opt_critic.init(pc))

    def act(self, state: AgentState, obs, key=None, noise: bool = False):
        """calc_action (train.py:14): deterministic policy + optional
        exploration noise, clipped to the action box."""
        a = self.actor.apply(state.actor, obs)
        if noise:
            a = a + self.cfg.noise_std * self.cfg.act_limit * \
                jax.random.normal(key, a.shape, a.dtype)
        return jnp.clip(a, -self.cfg.act_limit, self.cfg.act_limit)

    def update(self, state: AgentState, batch: Transition):
        """One critic + actor step with polyak target updates
        (update_params, train.py:19)."""
        cfg = self.cfg

        def critic_loss(pc):
            q = self.critic.apply(pc, batch.obs, batch.act)
            a_next = self.actor.apply(state.actor_t, batch.next_obs)
            q_next = self.critic.apply(state.critic_t, batch.next_obs, a_next)
            target = batch.rew + cfg.gamma * (1.0 - batch.done) * q_next
            return jnp.mean((q - jax.lax.stop_gradient(target)) ** 2)

        lc, gc = jax.value_and_grad(critic_loss)(state.critic)
        up_c, opt_c = self.opt_critic.update(gc, state.opt_c, state.critic)
        critic = optax.apply_updates(state.critic, up_c)

        def actor_loss(pa):
            a = self.actor.apply(pa, batch.obs)
            return -jnp.mean(self.critic.apply(critic, batch.obs, a))

        la, ga = jax.value_and_grad(actor_loss)(state.actor)
        up_a, opt_a = self.opt_actor.update(ga, state.opt_a, state.actor)
        actor = optax.apply_updates(state.actor, up_a)

        polyak = lambda t, p: jax.tree.map(
            lambda a, b: (1 - cfg.tau) * a + cfg.tau * b, t, p)
        new = AgentState(
            actor=actor, critic=critic,
            actor_t=polyak(state.actor_t, actor),
            critic_t=polyak(state.critic_t, critic),
            opt_a=opt_a, opt_c=opt_c)
        return new, {"critic_loss": lc, "actor_loss": la}
