"""MATD3: multi-agent TD3 — twin centralized critics, target-policy
smoothing, delayed actor updates.

Part of the off-policy algorithm surface the reference exposes through the
external ``offpolicy`` package (``/root/reference/train/maddpg-v5/train.py:41-56``:
``matd3``/``rmatd3`` selectable next to maddpg/masac).  Built on the MADDPG
chassis (same stacked-agent params, device replay buffer, exploration and
training loop); the TD3 deltas follow Fujimoto et al. 2018.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import flax.linen as nn

from ..models.flax_networks import CentralizedQCritic
from ..models.networks import gumbel_softmax_st
from .maddpg import MADDPG, MADDPGConfig, MADDPGState

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class MATD3Config(MADDPGConfig):
    target_noise: float = 0.2
    target_noise_clip: float = 0.5
    policy_delay: int = 2


class TwinQCritic(nn.Module):
    """Two independent Q heads over the same (obs, act) input."""

    max_action: float = 1.0
    hidden: Tuple[int, ...] = (64, 64, 64)

    @nn.compact
    def __call__(self, obs_all: Array, act_all: Array):
        q1 = CentralizedQCritic(self.max_action, self.hidden)(obs_all, act_all)
        q2 = CentralizedQCritic(self.max_action, self.hidden)(obs_all, act_all)
        return q1, q2


class MATD3(MADDPG):
    def __init__(self, env, cfg: MATD3Config = MATD3Config(), num_envs: int = 32):
        super().__init__(env, cfg, num_envs)
        self.critic = TwinQCritic(cfg.high_action, cfg.hidden)

    # -- TD3 deltas over the MADDPG hooks -----------------------------------
    def _target_actions(self, ts, batch):
        """Target-policy smoothing: clipped Gaussian noise on the target
        actors' next actions, re-clipped to the action range."""
        cfg = self.cfg
        u_next = self._actor_all(ts.target_actor_params, batch["next_obs"])
        if self.discrete:
            # discrete analog of target smoothing: stochastic hard
            # gumbel-softmax sample of the target logits (the reference
            # offpolicy package's discrete matd3 path); fold at n_agents —
            # the base class folds per-agent at 0..n_agents-1 (maddpg.py),
            # so an index-valued fold would collide with that agent's key
            return jax.lax.stop_gradient(
                gumbel_softmax_st(
                    jax.random.fold_in(batch["noise_key"], self.n_agents),
                    u_next,
                )
            )
        noise = jnp.clip(
            cfg.target_noise
            * jax.random.normal(batch["noise_key"], u_next.shape, u_next.dtype),
            -cfg.target_noise_clip,
            cfg.target_noise_clip,
        )
        return jnp.clip(u_next + noise, -cfg.high_action, cfg.high_action)

    def _q_target(self, tcparams_i, on_in, un_in, ts):
        q1, q2 = self.critic.apply(tcparams_i, on_in, un_in)
        return jnp.minimum(q1, q2)

    def _critic_bellman_err(self, cparams_i, o_in, u_in, target):
        q1, q2 = self.critic.apply(cparams_i, o_in, u_in)
        return (target - q1) ** 2 + (target - q2) ** 2, jnp.abs(target - q1)

    def _q_policy(self, cparams_i, o_in, u_sub):
        q1, _ = self.critic.apply(cparams_i, o_in, u_sub)
        return q1

    def _update_once(self, ts: MADDPGState, batch, weights=None):
        """Delayed policy updates: the critic trains every step, the actor
        (and both target nets) every ``policy_delay`` steps."""
        cfg = self.cfg
        new_ts, aux = super()._update_once(ts, batch, weights)
        do_actor = ts.grad_updates % cfg.policy_delay == 0
        sel = lambda a, b: jax.tree.map(
            lambda x, y: jnp.where(do_actor, x, y), a, b
        )
        ts = new_ts.replace(
            actor_params=sel(new_ts.actor_params, ts.actor_params),
            actor_opt=sel(new_ts.actor_opt, ts.actor_opt),
            target_actor_params=sel(new_ts.target_actor_params, ts.target_actor_params),
            target_critic_params=sel(
                new_ts.target_critic_params, ts.target_critic_params
            ),
            grad_updates=ts.grad_updates + 1,
        )
        return ts, aux
