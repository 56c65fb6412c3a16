"""RMASAC: recurrent multi-agent Soft Actor-Critic.

Completes the recurrent off-policy triple of the reference zoo
(``rmaddpg``/``rmatd3``/``rmasac``, ``/root/reference/train/maddpg-v5/train.py:41-49``).
GRU encoders with a tanh-Gaussian head, twin centralized MLP critics, and
automatic temperature — trained over whole-episode sequences from the shared
:class:`~gym_formation_tpu.algos.rmaddpg.EpisodeBuffer`, everything in one
jitted program.
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
from ..models.networks import orthogonal_init
from .masac import LOG_STD_MAX, LOG_STD_MIN, sample_squashed as _sample_squashed
from .matd3 import TwinQCritic
from .rmaddpg import EpisodeBuffer

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class RMASACConfig:
    lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.95
    tau: float = 0.01
    buffer_episodes: int = 4096
    batch_episodes: int = 32
    gru_hidden: int = 64
    critic_hidden: Tuple[int, ...] = (64, 64, 64)
    high_action: float = 1.0
    init_alpha: float = 0.2
    autotune_alpha: bool = True
    episodes_per_iter: int = 8
    updates_per_iter: int = 4


class RecurrentSquashedActor(nn.Module):
    """obs → Dense → GRU → (mean, log_std) per step."""

    act_dim: int
    hidden: int = 64

    @nn.compact
    def __call__(self, carry: Array, obs: Array, reset: Array):
        x = nn.relu(nn.Dense(self.hidden, kernel_init=orthogonal_init())(obs))
        carry = jnp.where(reset[..., None], 0.0, carry)
        carry, h = nn.GRUCell(self.hidden)(carry, x)
        mean = nn.Dense(self.act_dim, kernel_init=orthogonal_init(0.01))(h)
        log_std = nn.Dense(self.act_dim, kernel_init=orthogonal_init(0.01))(h)
        return carry, (mean, jnp.clip(log_std, LOG_STD_MIN, LOG_STD_MAX))


@struct.dataclass
class RMASACState:
    actor_params: dict  # stacked [N, ...]
    critic_params: dict
    target_critic_params: dict
    log_alpha: Array
    actor_opt: optax.OptState
    critic_opt: optax.OptState
    alpha_opt: optax.OptState
    env_steps: Array


class RMASAC:
    def __init__(
        self, env: FormationEnv, cfg: RMASACConfig = RMASACConfig(), num_envs: int = 8
    ):
        self.env = env
        self.cfg = cfg
        self.num_envs = num_envs
        self.n_agents = env.num_agents
        self.obs_dim = env.scenario.obs_dim
        self.act_dim = env.act_dim
        self.T = env.world_length
        self.target_entropy = -float(self.act_dim)
        self.actor = RecurrentSquashedActor(self.act_dim, cfg.gru_hidden)
        self.critic = TwinQCritic(cfg.high_action, cfg.critic_hidden)
        self.actor_tx = optax.adam(cfg.lr)
        self.critic_tx = optax.adam(cfg.lr)
        self.alpha_tx = optax.adam(cfg.alpha_lr)

    def _actor_step(self, params, carry, obs, reset):
        reset_n = jnp.broadcast_to(reset[..., None], obs.shape[:-1])
        step = lambda p, c, o, r: self.actor.apply(p, c, o, r)
        return jax.vmap(step, in_axes=(0, -2, -2, -1), out_axes=(-2, (-2, -2)))(
            params, carry, obs, reset_n
        )

    def _actor_rollout(self, params, obs_seq, key):
        """[M, T, N, do] → sampled actions + logp over the episode."""
        M, T = obs_seq.shape[:2]
        h0 = jnp.zeros((M, self.n_agents, self.cfg.gru_hidden))

        def step_fn(carry, inp):
            h, reset = carry
            obs_t, k = inp
            h, (mean, log_std) = self._actor_step(params, h, obs_t, reset)
            a, logp = _sample_squashed(k, mean, log_std, self.cfg.high_action)
            return (h, jnp.zeros_like(reset)), (a, logp)

        (_, _), (acts, logps) = jax.lax.scan(
            step_fn,
            (h0, jnp.ones((M,), bool)),
            (obs_seq.swapaxes(0, 1), jax.random.split(key, T)),
        )
        return acts.swapaxes(0, 1), logps.swapaxes(0, 1)  # [M,T,N,da], [M,T,N]

    def init(self, key: Array):
        cfg = self.cfg
        n = self.n_agents
        k_net, _ = jax.random.split(key)

        @jax.jit
        def _init(k):
            ka, kc = jax.random.split(k)
            h0 = jnp.zeros((1, cfg.gru_hidden))
            obs0 = jnp.zeros((1, self.obs_dim))
            r0 = jnp.zeros((1,), bool)
            oall0 = jnp.zeros((1, self.obs_dim * n))
            uall0 = jnp.zeros((1, self.act_dim * n))
            actor_params = jax.vmap(lambda kk: self.actor.init(kk, h0, obs0, r0))(
                jax.random.split(ka, n)
            )
            critic_params = jax.vmap(lambda kk: self.critic.init(kk, oall0, uall0))(
                jax.random.split(kc, n)
            )
            log_alpha = jnp.full((n,), jnp.log(cfg.init_alpha))
            return RMASACState(
                actor_params=actor_params,
                critic_params=critic_params,
                target_critic_params=jax.tree.map(lambda x: x + 0, critic_params),
                log_alpha=log_alpha,
                actor_opt=self.actor_tx.init(actor_params),
                critic_opt=self.critic_tx.init(critic_params),
                alpha_opt=self.alpha_tx.init(log_alpha),
                env_steps=jnp.zeros((), jnp.int32),
            )

        ts = _init(k_net)
        buffer = EpisodeBuffer.create(
            cfg.buffer_episodes, self.T, n, self.obs_dim, self.act_dim
        )
        return ts, buffer

    def _collect_episodes(self, ts: RMASACState, key):
        B = self.num_envs
        k_reset, k_roll = jax.random.split(key)
        env_state, obs0 = jax.vmap(self.env.reset)(jax.random.split(k_reset, B))
        h0 = jnp.zeros((B, self.n_agents, self.cfg.gru_hidden))

        def step_fn(carry, k):
            env_state, obs, h, reset = carry
            h, (mean, log_std) = self._actor_step(ts.actor_params, h, obs, reset)
            act, _ = _sample_squashed(k, mean, log_std, self.cfg.high_action)
            env_state, out = jax.vmap(self.env.step)(env_state, act)
            return (env_state, out.obs, h, jnp.zeros_like(reset)), (
                obs, act, out.reward, benchmark_means(out.info)
            )

        (_, last_obs, _, _), (obs_seq, act_seq, rew_seq, bench) = jax.lax.scan(
            step_fn,
            (env_state, obs0, h0, jnp.ones((B,), bool)),
            jax.random.split(k_roll, self.T),
        )
        obs_full = jnp.concatenate([obs_seq.swapaxes(0, 1), last_obs[:, None]], axis=1)
        return (
            obs_full,
            act_seq.swapaxes(0, 1),
            rew_seq.swapaxes(0, 1),
            {k: v.mean() for k, v in bench.items()},
        )

    def _losses(self, params, ts: RMASACState, batch, key):
        cfg = self.cfg
        actor_params, critic_params, log_alpha = (
            params["actor"], params["critic"], params["log_alpha"],
        )
        alpha = jnp.exp(log_alpha)
        M, Tp1 = batch["obs"].shape[:2]
        T = Tp1 - 1
        k_next, k_new = jax.random.split(key)
        # fresh recurrent action sequences: roll the FULL episode for targets
        # (hidden at t+1 must reflect obs_0..obs_{t+1}) and slice; the
        # current-step rollout starts at obs_0 so zero hidden is correct
        a_next_f, logp_next_f = self._actor_rollout(actor_params, batch["obs"], k_next)
        a_next, logp_next = a_next_f[:, 1:], logp_next_f[:, 1:]
        a_new, logp_new = self._actor_rollout(actor_params, batch["obs"][:, :-1], k_new)

        o_flat = batch["obs"][:, :-1].reshape(M * T, -1)
        on_flat = batch["obs"][:, 1:].reshape(M * T, -1)
        u_flat = batch["action"].reshape(M * T, -1)
        un_flat = a_next.reshape(M * T, -1)
        nonterm = jnp.ones((M, T)).at[:, -1].set(0.0).reshape(M * T)

        def per_agent(i, cparams_i, tcparams_i):
            q1n, q2n = self.critic.apply(tcparams_i, on_flat, un_flat)
            lp_n = logp_next[..., i].reshape(M * T)
            soft_q_next = jnp.minimum(q1n, q2n) - alpha[i] * lp_n
            r_i = batch["reward"][..., i].reshape(M * T)
            target = jax.lax.stop_gradient(r_i + cfg.gamma * soft_q_next * nonterm)
            q1, q2 = self.critic.apply(cparams_i, o_flat, u_flat)
            critic_loss = jnp.mean((target - q1) ** 2) + jnp.mean((target - q2) ** 2)
            u_sub = (
                batch["action"].at[..., i, :].set(a_new[..., i, :]).reshape(M * T, -1)
            )
            q1p, q2p = self.critic.apply(jax.lax.stop_gradient(cparams_i), o_flat, u_sub)
            lp = logp_new[..., i].reshape(M * T)
            actor_loss = jnp.mean(
                jax.lax.stop_gradient(alpha[i]) * lp - jnp.minimum(q1p, q2p)
            )
            alpha_loss = -jnp.mean(
                log_alpha[i] * jax.lax.stop_gradient(lp + self.target_entropy)
            )
            return critic_loss, actor_loss, alpha_loss, -jnp.mean(lp)

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

    def _update_once(self, ts: RMASACState, batch, key):
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

    @partial(jax.jit, static_argnums=0, donate_argnums=(1, 2))
    def train_step(self, ts: RMASACState, buffer: EpisodeBuffer, key):
        cfg = self.cfg

        def collect(carry, k):
            ts, buffer = carry
            obs, act, rew, bench = self._collect_episodes(ts, k)
            buffer = buffer.insert(obs, act, rew)
            ts = ts.replace(env_steps=ts.env_steps + self.num_envs * self.T)
            return (ts, buffer), (rew.mean(), bench)

        (ts, buffer), (rews, bench) = jax.lax.scan(
            collect, (ts, buffer), jax.random.split(key, cfg.episodes_per_iter)
        )

        def upd(ts, k):
            batch = buffer.sample(k, cfg.batch_episodes)
            return self._update_once(ts, batch, jax.random.fold_in(k, 3))

        keys = jax.random.split(jax.random.fold_in(key, 1), cfg.updates_per_iter)
        ts, aux = jax.lax.cond(
            buffer.size >= cfg.batch_episodes,
            lambda ts: jax.lax.scan(upd, ts, keys),
            lambda ts: (
                ts,
                {
                    k: jnp.zeros(cfg.updates_per_iter)
                    for k in ("critic_loss", "actor_loss", "alpha", "entropy")
                },
            ),
            ts,
        )
        metrics = {k: v.mean() for k, v in aux.items()}
        metrics["mean_step_reward"] = rews.mean()
        metrics["buffer_episodes"] = buffer.size
        metrics.update({k: v.mean() for k, v in bench.items()})
        return ts, buffer, metrics
