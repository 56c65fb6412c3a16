"""MASAC: multi-agent Soft Actor-Critic with centralized twin critics.

Completes the continuous off-policy surface the reference reaches through the
``offpolicy`` package (``train/maddpg-v5/train.py:41-56``:
``masac``/``rmasac``).  Same chassis as MADDPG (stacked per-agent params,
device replay buffer, one jitted collect+update program); the SAC machinery —
tanh-Gaussian reparameterized actor, twin Q minimum, automatic temperature
tuned to −act_dim target entropy — follows Haarnoja et al. 2018.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import optax
import flax.linen as nn
from ..core import struct

from ..env import FormationEnv, benchmark_means
from ..models.flax_networks import MLP
from ..models.networks import (
    LogitsActor,
    categorical_entropy,
    categorical_logp,
    gumbel_softmax_st,
    onehot_from_logits,
    orthogonal_init,
)
from .maddpg import ReplayBuffer
from .matd3 import TwinQCritic

Array = jnp.ndarray

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


@dataclasses.dataclass(frozen=True)
class MASACConfig:
    lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.95
    tau: float = 0.01
    buffer_size: int = 500_000
    batch_size: int = 256
    hidden: Tuple[int, ...] = (64, 64, 64)
    high_action: float = 1.0
    init_alpha: float = 0.2
    autotune_alpha: bool = True
    mask_done: bool = False  # match the zoo's no-done-mask convention
    # discrete entropy target = ratio·log|A| (SAC-discrete uses 0.98; that
    # forces a near-uniform policy on this task — 0.6 learns)
    target_entropy_ratio: float = 0.6
    steps_per_iter: int = 32
    updates_per_iter: int = 32
    warmup_random_steps: int = 256


class SquashedGaussianActor(nn.Module):
    act_dim: int
    high_action: float = 1.0
    hidden: Tuple[int, ...] = (64, 64, 64)

    @nn.compact
    def __call__(self, obs: Array):
        h = MLP(self.hidden)(obs)
        mean = nn.Dense(self.act_dim, kernel_init=orthogonal_init(0.01))(h)
        log_std = nn.Dense(self.act_dim, kernel_init=orthogonal_init(0.01))(h)
        return mean, jnp.clip(log_std, LOG_STD_MIN, LOG_STD_MAX)


def sample_squashed(key, mean, log_std, high_action):
    """Reparameterized tanh-Gaussian sample + log-prob with change of
    variables."""
    std = jnp.exp(log_std)
    eps = jax.random.normal(key, mean.shape, mean.dtype)
    pre = mean + std * eps
    logp = jnp.sum(
        -0.5 * eps**2 - log_std - 0.5 * jnp.log(2 * jnp.pi), axis=-1
    )
    a = jnp.tanh(pre)
    logp = logp - jnp.sum(jnp.log(jnp.clip(1 - a**2, 1e-6)), axis=-1)
    return a * high_action, logp


@struct.dataclass
class MASACState:
    actor_params: dict  # stacked [N, ...]
    critic_params: dict
    target_critic_params: dict
    log_alpha: Array  # [N]
    actor_opt: optax.OptState
    critic_opt: optax.OptState
    alpha_opt: optax.OptState
    env_steps: Array


class MASAC:
    def __init__(
        self, env: FormationEnv, cfg: MASACConfig = MASACConfig(), num_envs: int = 32
    ):
        self.env = env
        self.cfg = cfg
        self.num_envs = num_envs
        self.n_agents = env.num_agents
        self.obs_dim = env.scenario.obs_dim
        self.act_dim = env.act_dim
        # discrete: gumbel-softmax SAC (the offpolicy package's discrete
        # masac path), entropy target ratio·log|A| (SAC-discrete convention)
        self.discrete = bool(env.discrete_action and not env.discrete_action_input)
        if self.discrete:
            self.target_entropy = cfg.target_entropy_ratio * float(
                jnp.log(self.act_dim)
            )
            self.actor = LogitsActor(self.act_dim, cfg.hidden)
        else:
            self.target_entropy = -float(self.act_dim)
            self.actor = SquashedGaussianActor(
                self.act_dim, cfg.high_action, cfg.hidden
            )
        self.critic = TwinQCritic(cfg.high_action, cfg.hidden)
        self.actor_tx = optax.adam(cfg.lr)
        self.critic_tx = optax.adam(cfg.lr)
        self.alpha_tx = optax.adam(cfg.alpha_lr)

    def _actor_all(self, params, obs):
        return jax.vmap(self.actor.apply, in_axes=(0, -2), out_axes=-2)(params, obs)

    def _policy_sample(self, key, dist):
        """Reparameterized sample + log-prob: tanh-Gaussian (continuous) or
        straight-through gumbel-softmax one-hot (discrete — ∂a/∂logits flows
        through the softmax relaxation; logp is the categorical mass of the
        sampled action, differentiable in the logits)."""
        if self.discrete:
            a = gumbel_softmax_st(key, dist)
            logp = categorical_logp(dist, jax.lax.stop_gradient(a))
            return a, logp
        mean, log_std = dist
        return sample_squashed(key, mean, log_std, self.cfg.high_action)

    def init(self, key: Array):
        cfg = self.cfg
        n = self.n_agents
        ka, kc, k_env = jax.random.split(key, 3)

        @jax.jit
        def _init(ka, kc):
            obs0 = jnp.zeros((1, self.obs_dim))
            oall0 = jnp.zeros((1, self.obs_dim * n))
            uall0 = jnp.zeros((1, self.act_dim * n))
            actor_params = jax.vmap(lambda k: self.actor.init(k, obs0))(
                jax.random.split(ka, n)
            )
            critic_params = jax.vmap(lambda k: self.critic.init(k, oall0, uall0))(
                jax.random.split(kc, n)
            )
            log_alpha = jnp.full((n,), jnp.log(cfg.init_alpha))
            return MASACState(
                actor_params=actor_params,
                critic_params=critic_params,
                target_critic_params=jax.tree.map(lambda x: x + 0, critic_params),
                log_alpha=log_alpha,
                actor_opt=self.actor_tx.init(actor_params),
                critic_opt=self.critic_tx.init(critic_params),
                alpha_opt=self.alpha_tx.init(log_alpha),
                env_steps=jnp.zeros((), jnp.int32),
            )

        ts = _init(ka, kc)
        buffer = ReplayBuffer.create(cfg.buffer_size, n, self.obs_dim, self.act_dim)
        # jit: eager vmapped reset is pathological on remote backends
        env_state, obs = jax.jit(jax.vmap(self.env.reset))(
            jax.random.split(k_env, self.num_envs)
        )
        return ts, buffer, env_state, obs

    def explore_actions(self, ts: MASACState, obs: Array, key) -> Array:
        """Sample from the policy; uniform random during warmup."""
        k_s, k_u = jax.random.split(key)
        dist = self._actor_all(ts.actor_params, obs)
        a, _ = self._policy_sample(jax.random.fold_in(k_s, 0), dist)
        if self.discrete:
            rand_idx = jax.random.randint(k_u, a.shape[:-1], 0, self.act_dim)
            uniform = jax.nn.one_hot(rand_idx, self.act_dim, dtype=a.dtype)
        else:
            uniform = jax.random.uniform(
                k_u, a.shape, a.dtype, -self.cfg.high_action, self.cfg.high_action
            )
        warm = ts.env_steps < self.cfg.warmup_random_steps
        return jnp.where(warm, uniform, a)

    def _losses(self, params, ts: MASACState, batch, key):
        cfg = self.cfg
        actor_params, critic_params, log_alpha = (
            params["actor"], params["critic"], params["log_alpha"],
        )
        M = batch["obs"].shape[0]
        o_all = batch["obs"].reshape(M, -1)
        on_all = batch["next_obs"].reshape(M, -1)
        u_all = batch["action"].reshape(M, -1)
        alpha = jnp.exp(log_alpha)  # [N]
        nonterm = (
            (1.0 - batch["done"].astype(jnp.float32)) if cfg.mask_done else 1.0
        )
        k_next, k_new = jax.random.split(key)
        # next actions from the *current* actors (SAC), with entropy term
        dist_n = self._actor_all(actor_params, batch["next_obs"])
        a_next, logp_next = self._policy_sample(k_next, dist_n)
        un_all = a_next.reshape(M, -1)
        dist_c = self._actor_all(actor_params, batch["obs"])
        a_new, logp_new = self._policy_sample(k_new, dist_c)
        if self.discrete:
            # exact categorical entropy in the soft-value / alpha terms
            # (SAC-discrete): the single-sample logp estimator has unbounded
            # variance — once alpha grows, -alpha·logp of a rare sampled
            # action blows up the critic targets (measured: alpha 0.2 → 1e6,
            # critic loss → 3e10 over 2M steps). E[logp] = -H is bounded by
            # log|A| and keeps the temperature feedback loop stable.
            logp_next = -categorical_entropy(dist_n)
            logp_new = -categorical_entropy(dist_c)

        def per_agent(i, cparams_i, tcparams_i):
            q1n, q2n = self.critic.apply(tcparams_i, on_all, un_all)
            soft_q_next = jnp.minimum(q1n, q2n) - alpha[i] * logp_next[:, i]
            target = batch["reward"][:, i] + cfg.gamma * soft_q_next * nonterm
            target = jax.lax.stop_gradient(target)
            q1, q2 = self.critic.apply(cparams_i, o_all, u_all)
            critic_loss = jnp.mean((target - q1) ** 2) + jnp.mean((target - q2) ** 2)
            # actor: substitute own fresh action
            u_sub = batch["action"].at[:, i].set(a_new[:, i]).reshape(M, -1)
            q1p, q2p = self.critic.apply(
                jax.lax.stop_gradient(cparams_i), o_all, u_sub
            )
            actor_loss = jnp.mean(
                jax.lax.stop_gradient(alpha[i]) * logp_new[:, i]
                - jnp.minimum(q1p, q2p)
            )
            alpha_loss = -jnp.mean(
                log_alpha[i]
                * jax.lax.stop_gradient(logp_new[:, i] + self.target_entropy)
            )
            return critic_loss, actor_loss, alpha_loss, -jnp.mean(logp_new[:, i])

        idx = jnp.arange(self.n_agents)
        c_l, a_l, al_l, ent = jax.vmap(per_agent, in_axes=(0, 0, 0))(
            idx, critic_params, ts.target_critic_params
        )
        total = c_l.sum() + a_l.sum() + (al_l.sum() if cfg.autotune_alpha else 0.0)
        return total, {
            "critic_loss": c_l.mean(),
            "actor_loss": a_l.mean(),
            "alpha": alpha.mean(),
            "entropy": ent.mean(),
        }

    def _update_once(self, ts: MASACState, batch, key):
        cfg = self.cfg
        params = {
            "actor": ts.actor_params,
            "critic": ts.critic_params,
            "log_alpha": ts.log_alpha,
        }
        grads, aux = jax.grad(self._losses, has_aux=True)(params, ts, batch, key)
        a_up, actor_opt = self.actor_tx.update(grads["actor"], ts.actor_opt)
        c_up, critic_opt = self.critic_tx.update(grads["critic"], ts.critic_opt)
        actor_params = optax.apply_updates(ts.actor_params, a_up)
        critic_params = optax.apply_updates(ts.critic_params, c_up)
        if cfg.autotune_alpha:
            al_up, alpha_opt = self.alpha_tx.update(grads["log_alpha"], ts.alpha_opt)
            log_alpha = optax.apply_updates(ts.log_alpha, al_up)
        else:
            alpha_opt, log_alpha = ts.alpha_opt, ts.log_alpha
        targets = jax.tree.map(
            lambda t, p: (1 - cfg.tau) * t + cfg.tau * p,
            ts.target_critic_params,
            critic_params,
        )
        return (
            ts.replace(
                actor_params=actor_params,
                critic_params=critic_params,
                target_critic_params=targets,
                log_alpha=log_alpha,
                actor_opt=actor_opt,
                critic_opt=critic_opt,
                alpha_opt=alpha_opt,
            ),
            aux,
        )

    @partial(jax.jit, static_argnums=0, donate_argnums=(1, 2, 3, 4))
    def train_step(self, ts: MASACState, buffer: ReplayBuffer, env_state, obs, key):
        cfg = self.cfg

        def env_step(carry, k):
            ts, buffer, env_state, obs = carry
            actions = self.explore_actions(ts, obs, k)
            env_state, out = jax.vmap(self.env.step)(env_state, actions)
            next_obs = out.info.get("terminal_obs", out.obs)
            buffer = buffer.insert(obs, actions, out.reward, next_obs, out.done[:, 0])
            ts = ts.replace(env_steps=ts.env_steps + self.num_envs)
            return (ts, buffer, env_state, out.obs), (
                out.reward.mean(),
                benchmark_means(out.info),
            )

        (ts, buffer, env_state, obs), (step_rew, bench) = jax.lax.scan(
            env_step,
            (ts, buffer, env_state, obs),
            jax.random.split(key, cfg.steps_per_iter),
        )

        def upd(ts, k):
            batch = buffer.sample(k, cfg.batch_size)
            return self._update_once(ts, batch, jax.random.fold_in(k, 3))

        keys = jax.random.split(jax.random.fold_in(key, 1), cfg.updates_per_iter)

        def do_train(ts):
            return jax.lax.scan(upd, ts, keys)

        def skip(ts):
            zero = {
                k: jnp.zeros(cfg.updates_per_iter)
                for k in ("critic_loss", "actor_loss", "alpha", "entropy")
            }
            return ts, zero

        ts, aux = jax.lax.cond(buffer.size >= cfg.batch_size, do_train, skip, ts)
        metrics = {k: v.mean() for k, v in aux.items()}
        metrics["mean_step_reward"] = step_rew.mean()
        metrics["buffer_size"] = buffer.size
        metrics.update({k: v.mean() for k, v in bench.items()})
        return ts, buffer, env_state, obs, metrics

    def eval_actions(self, ts: MASACState, obs: Array) -> Array:
        dist = self._actor_all(ts.actor_params, obs)
        if self.discrete:
            return onehot_from_logits(dist)
        return jnp.tanh(dist[0]) * self.cfg.high_action
