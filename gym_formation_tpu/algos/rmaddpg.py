"""RMADDPG / RMATD3: recurrent off-policy actors over episode-sequence replay.

The reference's recurrent off-policy set (``rmaddpg``/``rmatd3``/``rmasac``,
``/root/reference/train/maddpg-v5/train.py:41-49``: "rollout_threads=1 only",
with ``data_chunk_length`` 80 BPTT chunks, ``config.py:89-90``) trains GRU
policies from a buffer of whole episodes.

Design: episodes are collected by a ``lax.scan`` over the vmapped env (one
episode per env per collect call, hidden states zeroed at the start) into an
episode-major device buffer [cap, T, ...]; updates sample episode batches and
BPTT-scan actor GRUs over the full episode, with the centralized (optionally
twin) MLP critic applied per step — all one jitted program, in contrast to
the reference's single-thread recurrent rollout.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import optax
from ..core import struct

from ..env import FormationEnv, benchmark_means
from ..models.flax_networks import CentralizedQCritic, GRUPolicy
from .matd3 import TwinQCritic

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class RMADDPGConfig:
    lr_actor: float = 1e-4
    lr_critic: float = 1e-3
    gamma: float = 0.95
    tau: float = 0.01
    buffer_episodes: int = 4096
    batch_episodes: int = 32
    gru_hidden: int = 64
    critic_hidden: Tuple[int, ...] = (64, 64, 64)
    high_action: float = 1.0
    noise_rate: float = 0.1
    explore_min: float = 0.05
    explore_decay: float = 5e-6
    mask_done: bool = True  # terminal step bootstraps to 0 within the episode
    episodes_per_iter: int = 8  # episode batches collected per train_step
    updates_per_iter: int = 4
    twin: bool = False  # True → RMATD3 (twin critics + min-Q target)
    target_noise: float = 0.2
    target_noise_clip: float = 0.5


@struct.dataclass
class EpisodeBuffer:
    """Episode-major replay: whole fixed-length episodes per slot."""

    obs: Array  # [cap, T+1, N, do] (includes initial obs)
    action: Array  # [cap, T, N, da]
    reward: Array  # [cap, T, N]
    ptr: Array
    size: Array

    @classmethod
    def create(cls, cap, T, n_agents, obs_dim, act_dim):
        return cls(
            obs=jnp.zeros((cap, T + 1, n_agents, obs_dim)),
            action=jnp.zeros((cap, T, n_agents, act_dim)),
            reward=jnp.zeros((cap, T, n_agents)),
            ptr=jnp.zeros((), jnp.int32),
            size=jnp.zeros((), jnp.int32),
        )

    def insert(self, obs, action, reward) -> "EpisodeBuffer":
        cap = self.obs.shape[0]
        b = obs.shape[0]
        idx = (self.ptr + jnp.arange(b)) % cap
        return self.replace(
            obs=self.obs.at[idx].set(obs),
            action=self.action.at[idx].set(action),
            reward=self.reward.at[idx].set(reward),
            ptr=(self.ptr + b) % cap,
            size=jnp.minimum(self.size + b, cap),
        )

    def sample(self, key, batch):
        idx = jax.random.randint(key, (batch,), 0, jnp.maximum(self.size, 1))
        return {
            "obs": self.obs[idx],
            "action": self.action[idx],
            "reward": self.reward[idx],
        }


@struct.dataclass
class RMADDPGState:
    actor_params: dict  # stacked [N, ...]
    critic_params: dict
    target_actor_params: dict
    target_critic_params: dict
    actor_opt: optax.OptState
    critic_opt: optax.OptState
    noise: Array
    env_steps: Array
    grad_updates: Array


class RMADDPG:
    """Recurrent MADDPG (GRU actors, centralized MLP critic); ``twin=True``
    gives RMATD3 semantics (twin critics, min-Q, target smoothing)."""

    def __init__(
        self, env: FormationEnv, cfg: RMADDPGConfig = RMADDPGConfig(), num_envs: int = 8
    ):
        self.env = env
        self.cfg = cfg
        self.num_envs = num_envs
        self.n_agents = env.num_agents
        self.obs_dim = env.scenario.obs_dim
        self.act_dim = env.act_dim
        self.T = env.world_length
        self.actor = GRUPolicy(self.act_dim, cfg.gru_hidden)
        critic_cls = TwinQCritic if cfg.twin else CentralizedQCritic
        self.critic = critic_cls(cfg.high_action, cfg.critic_hidden)
        self.actor_tx = optax.adam(cfg.lr_actor)
        self.critic_tx = optax.adam(cfg.lr_critic)

    # -- stacked recurrent actor over agents --------------------------------
    def _actor_step(self, params, carry, obs, reset):
        """carry [.., N, H], obs [.., N, do], reset [..] → (carry, mean)."""
        reset_n = jnp.broadcast_to(reset[..., None], obs.shape[:-1])
        step = lambda p, c, o, r: self.actor.apply(p, c, o, r)
        carry, (mean, _) = jax.vmap(step, in_axes=(0, -2, -2, -1), out_axes=(-2, (-2, -2)))(
            params, carry, obs, reset_n
        )
        return carry, jnp.tanh(mean) * self.cfg.high_action

    def _actor_rollout(self, params, obs_seq):
        """Scan the stacked GRU actors over an episode.
        obs_seq [M, T, N, do] → actions [M, T, N, da]."""
        M = obs_seq.shape[0]
        h0 = jnp.zeros((M, self.n_agents, self.cfg.gru_hidden))
        t_first = jnp.ones((M,), bool)

        def step_fn(carry, obs_t):
            h, reset = carry
            h, act = self._actor_step(params, h, obs_t, reset)
            return (h, jnp.zeros_like(reset)), act

        (_, _), acts = jax.lax.scan(
            step_fn, (h0, t_first), obs_seq.swapaxes(0, 1)
        )
        return acts.swapaxes(0, 1)  # [M, T, N, da]

    def init(self, key: Array):
        cfg = self.cfg
        n = self.n_agents
        k_net, k_env = jax.random.split(key)

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
            copy = lambda t: jax.tree.map(lambda x: x + 0, t)
            return RMADDPGState(
                actor_params=actor_params,
                critic_params=critic_params,
                target_actor_params=copy(actor_params),
                target_critic_params=copy(critic_params),
                actor_opt=self.actor_tx.init(actor_params),
                critic_opt=self.critic_tx.init(critic_params),
                noise=jnp.asarray(cfg.noise_rate, jnp.float32),
                env_steps=jnp.zeros((), jnp.int32),
                grad_updates=jnp.zeros((), jnp.int32),
            )

        ts = _init(k_net)
        buffer = EpisodeBuffer.create(
            cfg.buffer_episodes, self.T, n, self.obs_dim, self.act_dim
        )
        return ts, buffer

    # -- collection: whole episodes -----------------------------------------
    def _collect_episodes(self, ts: RMADDPGState, key):
        """Roll ``num_envs`` fresh full episodes with exploration noise."""
        B = self.num_envs
        k_reset, k_roll = jax.random.split(key)
        env_state, obs0 = jax.vmap(self.env.reset)(jax.random.split(k_reset, B))
        h0 = jnp.zeros((B, self.n_agents, self.cfg.gru_hidden))

        def step_fn(carry, k):
            env_state, obs, h, reset = carry
            h, act = self._actor_step(ts.actor_params, h, obs, reset)
            noise = ts.noise * self.cfg.high_action * jax.random.normal(k, act.shape)
            act = jnp.clip(act + noise, -self.cfg.high_action, self.cfg.high_action)
            env_state, out = jax.vmap(self.env.step)(env_state, act)
            return (env_state, out.obs, h, jnp.zeros_like(reset)), (
                obs, act, out.reward, benchmark_means(out.info)
            )

        (_, last_obs, _, _), (obs_seq, act_seq, rew_seq, bench) = jax.lax.scan(
            step_fn,
            (env_state, obs0, h0, jnp.ones((B,), bool)),
            jax.random.split(k_roll, self.T),
        )
        # time-major → episode-major; append final obs
        obs_full = jnp.concatenate(
            [obs_seq.swapaxes(0, 1), last_obs[:, None]], axis=1
        )  # [B, T+1, N, do]
        return (
            obs_full,
            act_seq.swapaxes(0, 1),
            rew_seq.swapaxes(0, 1),
            {k: v.mean() for k, v in bench.items()},
        )

    # -- update --------------------------------------------------------------
    def _losses(self, actor_params, critic_params, ts, batch, key):
        cfg = self.cfg
        M, Tp1 = batch["obs"].shape[:2]
        T = Tp1 - 1
        # target next actions: roll the GRU over the FULL episode so the
        # hidden state at step t+1 reflects obs_0..obs_{t+1} (slicing the
        # rollout, not the inputs — starting from zero hidden at obs_1 would
        # misalign every target action's history)
        u_next = self._actor_rollout(ts.target_actor_params, batch["obs"])[:, 1:]
        if cfg.twin:
            noise = jnp.clip(
                cfg.target_noise * jax.random.normal(key, u_next.shape),
                -cfg.target_noise_clip,
                cfg.target_noise_clip,
            )
            u_next = jnp.clip(u_next + noise, -cfg.high_action, cfg.high_action)
        # fresh on-policy actions for the actor loss (steps 0..T-1)
        u_new = self._actor_rollout(actor_params, batch["obs"][:, :-1])

        o_flat = batch["obs"][:, :-1].reshape(M * T, -1)
        on_flat = batch["obs"][:, 1:].reshape(M * T, -1)
        u_flat = batch["action"].reshape(M * T, -1)
        un_flat = u_next.reshape(M * T, -1)
        # terminal mask: last step of each episode bootstraps to 0
        nonterm = jnp.ones((M, T)).at[:, -1].set(0.0 if cfg.mask_done else 1.0)
        nonterm = nonterm.reshape(M * T)

        def q_apply(p, o, u):
            if cfg.twin:
                q1, q2 = self.critic.apply(p, o, u)
                return q1, q2
            q = self.critic.apply(p, o, u)
            return q, q

        def per_agent(i, aparams_i_unused, cparams_i, tcparams_i):
            q1n, q2n = q_apply(tcparams_i, on_flat, un_flat)
            q_next = jnp.minimum(q1n, q2n) if cfg.twin else q1n
            r_i = batch["reward"][..., i].reshape(M * T)
            target = jax.lax.stop_gradient(r_i + cfg.gamma * q_next * nonterm)
            q1, q2 = q_apply(cparams_i, o_flat, u_flat)
            critic_loss = jnp.mean((target - q1) ** 2)
            if cfg.twin:
                critic_loss = critic_loss + jnp.mean((target - q2) ** 2)
            # actor: substitute own action sequence
            u_sub = (
                batch["action"].at[..., i, :].set(u_new[..., i, :]).reshape(M * T, -1)
            )
            qp, _ = q_apply(jax.lax.stop_gradient(cparams_i), o_flat, u_sub)
            actor_loss = -jnp.mean(qp)
            return critic_loss, actor_loss

        idx = jnp.arange(self.n_agents)
        c_l, a_l = jax.vmap(per_agent, in_axes=(0, 0, 0, 0))(
            idx, idx, critic_params, ts.target_critic_params
        )
        return c_l.sum() + a_l.sum(), {
            "critic_loss": c_l.mean(),
            "actor_loss": a_l.mean(),
        }

    def _update_once(self, ts: RMADDPGState, batch, key):
        cfg = self.cfg

        # one combined gradient (cross terms are stop_gradient'ed) — also
        # avoids re-running the whole-episode target-actor rollout twice
        def loss_fn(params):
            return self._losses(params["actor"], params["critic"], ts, batch, key)

        grads, aux = jax.grad(loss_fn, has_aux=True)(
            {"actor": ts.actor_params, "critic": ts.critic_params}
        )
        a_grads, c_grads = grads["actor"], grads["critic"]
        a_up, actor_opt = self.actor_tx.update(a_grads, ts.actor_opt)
        c_up, critic_opt = self.critic_tx.update(c_grads, ts.critic_opt)
        actor_params = optax.apply_updates(ts.actor_params, a_up)
        critic_params = optax.apply_updates(ts.critic_params, c_up)
        soft = lambda t, p: jax.tree.map(
            lambda a, b: (1 - cfg.tau) * a + cfg.tau * b, t, p
        )
        return (
            ts.replace(
                actor_params=actor_params,
                critic_params=critic_params,
                target_actor_params=soft(ts.target_actor_params, actor_params),
                target_critic_params=soft(ts.target_critic_params, critic_params),
                actor_opt=actor_opt,
                critic_opt=critic_opt,
                grad_updates=ts.grad_updates + 1,
            ),
            aux,
        )

    @partial(jax.jit, static_argnums=0, donate_argnums=(1, 2))
    def train_step(self, ts: RMADDPGState, buffer: EpisodeBuffer, key):
        cfg = self.cfg

        def collect(carry, k):
            ts, buffer = carry
            obs, act, rew, bench = self._collect_episodes(ts, k)
            buffer = buffer.insert(obs, act, rew)
            ts = ts.replace(
                noise=jnp.maximum(
                    cfg.explore_min, ts.noise - cfg.explore_decay * self.num_envs * self.T
                ),
                env_steps=ts.env_steps + self.num_envs * self.T,
            )
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
                    for k in ("critic_loss", "actor_loss")
                },
            ),
            ts,
        )
        metrics = {k: v.mean() for k, v in aux.items()}
        metrics["mean_step_reward"] = rews.mean()
        metrics["buffer_episodes"] = buffer.size
        metrics.update({k: v.mean() for k, v in bench.items()})
        return ts, buffer, metrics

    def eval_actions_episode(self, ts: RMADDPGState, obs_seq):
        """Greedy recurrent actions over an episode [B, T, N, do]."""
        return self._actor_rollout(ts.actor_params, obs_seq)
