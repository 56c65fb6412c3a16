"""``flax.linen`` networks of the off-policy and recurrent learners.

These learners need ``flax`` (an optional dependency: ``pip install
.[learners]``); MAPPO and the environment do not.  Scale mirrors the
reference baselines: 64-hidden MLPs with orthogonal init
(``train/maddpg-v1/maddpg/actor_critic.py:7-43``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax.numpy as jnp
import flax.linen as nn

from .networks import orthogonal_init, soft_bound

Array = jnp.ndarray


class MLP(nn.Module):
    """ReLU MLP trunk with orthogonal init (reference mappo/maddpg-v4 style:
    orthogonal + optional layer norm, ``maddpg-v4/parameters.yaml``)."""

    features: Sequence[int]
    activation: Callable = nn.relu
    use_layer_norm: bool = False

    @nn.compact
    def __call__(self, x: Array) -> Array:
        for f in self.features:
            x = nn.Dense(f, kernel_init=orthogonal_init())(x)
            x = self.activation(x)
            if self.use_layer_norm:
                x = nn.LayerNorm()(x)
        return x


class DeterministicActor(nn.Module):
    """DDPG/MADDPG actor: tanh-squashed deterministic policy ×max_action
    (reference ``maddpg-v1/maddpg/actor_critic.py:7-24``)."""

    act_dim: int
    max_action: float = 1.0
    hidden: Sequence[int] = (64, 64, 64)

    @nn.compact
    def __call__(self, obs: Array) -> Array:
        h = MLP(self.hidden)(obs)
        return self.max_action * jnp.tanh(
            nn.Dense(self.act_dim, kernel_init=orthogonal_init(0.01))(h)
        )


class CentralizedQCritic(nn.Module):
    """MADDPG centralized critic: Q(all obs, all actions) → scalar
    (reference ``maddpg-v1/maddpg/actor_critic.py:26-43``; actions scaled by
    max_action before concat, ``:37-39``)."""

    max_action: float = 1.0
    hidden: Sequence[int] = (64, 64, 64)

    @nn.compact
    def __call__(self, obs_all: Array, act_all: Array) -> Array:
        x = jnp.concatenate([obs_all, act_all / self.max_action], axis=-1)
        h = MLP(self.hidden)(x)
        return nn.Dense(1, kernel_init=orthogonal_init(1.0))(h).squeeze(-1)


class GRUPolicy(nn.Module):
    """Recurrent actor core: obs embed → GRU → Gaussian head.

    The recurrent (`r*`) variants of the reference zoo — rmappo is the tuned
    default (``train/mappo/train_formation.sh:13``), and the offpolicy side
    exposes rmaddpg/rmatd3/rmasac with rnn chunking
    (``train/maddpg-v5/config.py:89-90``)."""

    act_dim: int
    hidden: int = 64
    discrete: bool = False  # logits head instead of the Gaussian head

    @nn.compact
    def __call__(self, carry: Array, obs: Array, reset: Array):
        """One step: carry [., H], obs [., do], reset [.] bool (zeroes the
        carry at episode starts).  Returns (new_carry, dist) where dist is
        (mean, log_std) or, when ``discrete``, per-action logits."""
        x = nn.relu(nn.Dense(self.hidden, kernel_init=orthogonal_init())(obs))
        carry = jnp.where(reset[..., None], 0.0, carry)
        carry, h = nn.GRUCell(self.hidden)(carry, x)
        out = nn.Dense(self.act_dim, kernel_init=orthogonal_init(0.01))(h)
        if self.discrete:
            return carry, out
        log_std = self.param(
            "log_std", nn.initializers.constant(0.0), (self.act_dim,)
        )
        log_std = soft_bound(log_std, -5.0, 2.0)
        return carry, (out, jnp.broadcast_to(log_std, out.shape))

    def initial_carry(self, batch_shape) -> Array:
        return jnp.zeros(tuple(batch_shape) + (self.hidden,))


class GRUCritic(nn.Module):
    """Recurrent centralized value core: share_obs → GRU → V."""

    hidden: int = 64

    @nn.compact
    def __call__(self, carry: Array, share_obs: Array, reset: Array):
        x = nn.relu(nn.Dense(self.hidden, kernel_init=orthogonal_init())(share_obs))
        carry = jnp.where(reset[..., None], 0.0, carry)
        carry, h = nn.GRUCell(self.hidden)(carry, x)
        v = nn.Dense(1, kernel_init=orthogonal_init(1.0))(h).squeeze(-1)
        return carry, v

    def initial_carry(self, batch_shape) -> Array:
        return jnp.zeros(tuple(batch_shape) + (self.hidden,))
