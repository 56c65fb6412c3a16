"""Prioritized experience replay (device-resident).

Parity for the reference v4/v5 PER machinery
(``/root/reference/train/maddpg-v4/replaybuffer.py:51-112,246-394``:
``PrioritizedMlpReplayBuffer`` with Sum/Min segment trees, α=0.6, β=0.4
anneal; flag surface in ``maddpg-v4/parameters.yaml`` and
``maddpg-v5/config.py``).

Design: segment trees are a host-pointer structure; on accelerator the
priority vector is just an array and sampling is one categorical draw over
``p_i^α`` (a single fused softmax-free ``jax.random.categorical`` on raw
log-priorities), with importance weights ``(N·P(i))^{-β}`` normalized by the
batch max — the same estimator, no tree maintenance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import struct

from .maddpg import ReplayBuffer

Array = jnp.ndarray


@struct.dataclass
class PrioritizedReplayBuffer(ReplayBuffer):
    priority: Array = None  # [cap] raw |TD|+eps priorities
    max_priority: Array = None  # scalar running max for new transitions

    @classmethod
    def create(cls, cap: int, n_agents: int, obs_dim: int, act_dim: int):
        base = ReplayBuffer.create(cap, n_agents, obs_dim, act_dim)
        return cls(
            **{f: getattr(base, f) for f in (
                "obs", "action", "reward", "next_obs", "done", "ptr", "size"
            )},
            priority=jnp.zeros((cap,)),
            max_priority=jnp.ones(()),
        )

    def insert(self, obs, action, reward, next_obs, done):
        cap = self.obs.shape[0]
        b = obs.shape[0]
        idx = (self.ptr + jnp.arange(b)) % cap
        base = ReplayBuffer.insert(self, obs, action, reward, next_obs, done)
        return base.replace(
            priority=base.priority.at[idx].set(self.max_priority)
        )

    def sample_prioritized(self, key, batch_size: int, alpha: float, beta: Array):
        """Sample ∝ p^α; returns (batch, idx, importance weights [batch])."""
        cap = self.obs.shape[0]
        valid = jnp.arange(cap) < self.size
        logits = alpha * jnp.log(jnp.maximum(self.priority, 1e-12))
        logits = jnp.where(valid, logits, -jnp.inf)
        idx = jax.random.categorical(key, logits, shape=(batch_size,))
        batch = {
            "obs": self.obs[idx],
            "action": self.action[idx],
            "reward": self.reward[idx],
            "next_obs": self.next_obs[idx],
            "done": self.done[idx],
        }
        # P(i) over the valid set; weights (n·P)^-β normalized by max
        logZ = jax.scipy.special.logsumexp(logits)
        logP = logits[idx] - logZ
        n = jnp.maximum(self.size, 1).astype(logP.dtype)
        w = jnp.exp(-beta * (jnp.log(n) + logP))
        return batch, idx, w / jnp.max(w)

    def update_priorities(self, idx: Array, td_abs: Array, eps: float = 1e-6):
        p = td_abs + eps
        return self.replace(
            priority=self.priority.at[idx].set(p),
            max_priority=jnp.maximum(self.max_priority, jnp.max(p)),
        )


def beta_schedule(step: Array, beta0: float = 0.4, anneal_steps: int = 100_000) -> Array:
    """Linear β anneal from beta0 → 1 (the reference's per_beta_start/anneal)."""
    frac = jnp.clip(step / anneal_steps, 0.0, 1.0)
    return beta0 + (1.0 - beta0) * frac
