"""Recurrent QMIX / VDN: GRU agent Q-networks over episode-sequence replay.

In the reference zoo the names ``qmix``/``vdn`` select the *recurrent*
value-factorization learners (``/root/reference/train/maddpg-v5/train.py:41-49``,
rollout_threads=1, rnn chunking ``config.py:89-90``) while ``mqmix``/``mvdn``
are the MLP variants (:class:`gym_formation_tpu.algos.qmix.QMix` here).  This
module covers the recurrent pair: a shared GRU Q-network (agent-id one-hot)
scanned over whole episodes from the device-resident episode buffer, with the
monotonic mixing hypernetwork (or VDN sum) applied per step.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
import optax
import flax.linen as nn
from ..core import struct

from ..env import FormationEnv, benchmark_means
from ..models.flax_networks import MLP
from ..models.networks import orthogonal_init
from .qmix import QMixer
from .rmaddpg import EpisodeBuffer

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class RQMixConfig:
    mixer: str = "qmix"  # 'qmix' | 'vdn'
    lr: float = 5e-4
    gamma: float = 0.99
    tau: float = 0.005
    buffer_episodes: int = 4096
    batch_episodes: int = 32
    gru_hidden: int = 64
    mixer_embed: int = 32
    eps_start: float = 1.0
    eps_finish: float = 0.05
    eps_anneal_steps: int = 50_000
    double_q: bool = True
    episodes_per_iter: int = 8
    updates_per_iter: int = 4


class RecurrentQNet(nn.Module):
    """obs⊕id → Dense → GRU → Q[A], one step at a time."""

    n_actions: int
    hidden: int = 64

    @nn.compact
    def __call__(self, carry: Array, x: Array, reset: Array):
        h = nn.relu(nn.Dense(self.hidden, kernel_init=orthogonal_init())(x))
        carry = jnp.where(reset[..., None], 0.0, carry)
        carry, out = nn.GRUCell(self.hidden)(carry, h)
        q = nn.Dense(self.n_actions, kernel_init=orthogonal_init(0.01))(out)
        return carry, q


@struct.dataclass
class RQMixState:
    q_params: dict
    mixer_params: dict
    target_q_params: dict
    target_mixer_params: dict
    opt_state: optax.OptState
    env_steps: Array
    grad_updates: Array


class RQMix:
    N_ACTIONS = 5

    def __init__(
        self, env: FormationEnv, cfg: RQMixConfig = RQMixConfig(), num_envs: int = 8
    ):
        assert env.discrete_action, "RQMix requires a discrete_action env"
        self.env = env
        self.cfg = cfg
        self.num_envs = num_envs
        self.n_agents = env.num_agents
        self.obs_dim = env.scenario.obs_dim
        self.T = env.world_length
        self.qnet = RecurrentQNet(self.N_ACTIONS, cfg.gru_hidden)
        self.mixer = QMixer(self.n_agents, cfg.mixer_embed)
        self.tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(cfg.lr))
        self._ids = np.eye(self.n_agents, dtype=np.float32)

    def _q_step(self, params, carry, obs, reset):
        """carry [.., N, H], obs [.., N, do], reset [..] → (carry, q [.., N, A])."""
        ids = jnp.broadcast_to(jnp.asarray(self._ids), obs.shape[:-1] + (self.n_agents,))
        x = jnp.concatenate([obs, ids], axis=-1)
        reset_n = jnp.broadcast_to(reset[..., None], obs.shape[:-1])
        return self.qnet.apply(params, carry, x, reset_n)

    def _q_rollout(self, params, obs_seq):
        """[M, T, N, do] → Q values [M, T, N, A] with hidden reset at t=0."""
        M = obs_seq.shape[0]
        h0 = jnp.zeros((M, self.n_agents, self.cfg.gru_hidden))

        def step_fn(carry, obs_t):
            h, reset = carry
            h, q = self._q_step(params, h, obs_t, reset)
            return (h, jnp.zeros_like(reset)), q

        (_, _), qs = jax.lax.scan(
            step_fn, (h0, jnp.ones((M,), bool)), obs_seq.swapaxes(0, 1)
        )
        return qs.swapaxes(0, 1)

    def init(self, key: Array):
        cfg = self.cfg
        k_net, _ = jax.random.split(key)

        @jax.jit
        def _init(k):
            kq, km = jax.random.split(k)
            h0 = jnp.zeros((1, self.n_agents, cfg.gru_hidden))
            obs0 = jnp.zeros((1, self.n_agents, self.obs_dim))
            r0 = jnp.zeros((1,), bool)
            q_params = self.qnet.init(
                kq,
                h0,
                jnp.concatenate(
                    [obs0, jnp.broadcast_to(jnp.asarray(self._ids), (1, self.n_agents, self.n_agents))],
                    axis=-1,
                ),
                jnp.zeros((1, self.n_agents), bool),
            )
            if cfg.mixer == "qmix":
                mixer_params = self.mixer.init(
                    km,
                    jnp.zeros((1, self.n_agents)),
                    jnp.zeros((1, self.obs_dim * self.n_agents)),
                )
            else:
                mixer_params = {}
            params = {"q": q_params, "mixer": mixer_params}
            copy = lambda t: jax.tree.map(lambda x: x + 0, t)
            return RQMixState(
                q_params=q_params,
                mixer_params=mixer_params,
                target_q_params=copy(q_params),
                target_mixer_params=copy(mixer_params),
                opt_state=self.tx.init(params),
                env_steps=jnp.zeros((), jnp.int32),
                grad_updates=jnp.zeros((), jnp.int32),
            )

        ts = _init(k_net)
        buffer = EpisodeBuffer.create(
            cfg.buffer_episodes, self.T, self.n_agents, self.obs_dim, self.N_ACTIONS
        )
        return ts, buffer

    def epsilon(self, ts: RQMixState) -> Array:
        cfg = self.cfg
        frac = jnp.clip(ts.env_steps / cfg.eps_anneal_steps, 0.0, 1.0)
        return cfg.eps_start + (cfg.eps_finish - cfg.eps_start) * frac

    def _collect_episodes(self, ts: RQMixState, key):
        B = self.num_envs
        k_reset, k_roll = jax.random.split(key)
        env_state, obs0 = jax.vmap(self.env.reset)(jax.random.split(k_reset, B))
        h0 = jnp.zeros((B, self.n_agents, self.cfg.gru_hidden))
        eps = self.epsilon(ts)

        def step_fn(carry, k):
            env_state, obs, h, reset = carry
            h, q = self._q_step(ts.q_params, h, obs, reset)
            greedy = jnp.argmax(q, -1)
            rand = jax.random.randint(
                jax.random.fold_in(k, 0), greedy.shape, 0, self.N_ACTIONS
            )
            pick = jnp.where(
                jax.random.uniform(jax.random.fold_in(k, 1), greedy.shape) < eps,
                rand,
                greedy,
            )
            act = jax.nn.one_hot(pick, self.N_ACTIONS, dtype=obs.dtype)
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

    def _mix(self, mixer_params, q_chosen, state):
        if self.cfg.mixer == "qmix":
            return self.mixer.apply(mixer_params, q_chosen, state)
        return jnp.sum(q_chosen, axis=-1)

    def _loss(self, params, ts: RQMixState, batch):
        cfg = self.cfg
        M, Tp1 = batch["obs"].shape[:2]
        T = Tp1 - 1
        q_all = self._q_rollout(params["q"], batch["obs"])  # [M, T+1, N, A]
        act_idx = jnp.argmax(batch["action"], -1)  # [M, T, N]
        q_chosen = jnp.take_along_axis(
            q_all[:, :-1], act_idx[..., None], axis=-1
        ).squeeze(-1)  # [M, T, N]
        state_flat = batch["obs"][:, :-1].reshape(M * T, -1)
        q_tot = self._mix(
            params["mixer"], q_chosen.reshape(M * T, self.n_agents), state_flat
        ).reshape(M, T)

        q_next_tgt = self._q_rollout(ts.target_q_params, batch["obs"])[:, 1:]
        if cfg.double_q:
            sel = jnp.argmax(q_all[:, 1:], -1)
        else:
            sel = jnp.argmax(q_next_tgt, -1)
        qn_chosen = jnp.take_along_axis(q_next_tgt, sel[..., None], -1).squeeze(-1)
        next_state_flat = batch["obs"][:, 1:].reshape(M * T, -1)
        q_tot_next = self._mix(
            ts.target_mixer_params,
            qn_chosen.reshape(M * T, self.n_agents),
            next_state_flat,
        ).reshape(M, T)
        r = batch["reward"][..., 0]  # shared reward
        nonterm = jnp.ones((M, T)).at[:, -1].set(0.0)
        y = jax.lax.stop_gradient(r + cfg.gamma * q_tot_next * nonterm)
        loss = jnp.mean((y - q_tot) ** 2)
        return loss, {"q_loss": loss, "q_tot": q_tot.mean()}

    def _update_once(self, ts: RQMixState, batch):
        cfg = self.cfg
        params = {"q": ts.q_params, "mixer": ts.mixer_params}
        grads, aux = jax.grad(self._loss, has_aux=True)(params, ts, batch)
        updates, opt_state = self.tx.update(grads, ts.opt_state, params)
        new = optax.apply_updates(params, updates)
        soft = lambda t, p: jax.tree.map(
            lambda a, b: (1 - cfg.tau) * a + cfg.tau * b, t, p
        )
        return (
            ts.replace(
                q_params=new["q"],
                mixer_params=new["mixer"],
                target_q_params=soft(ts.target_q_params, new["q"]),
                target_mixer_params=soft(ts.target_mixer_params, new["mixer"]),
                opt_state=opt_state,
                grad_updates=ts.grad_updates + 1,
            ),
            aux,
        )

    @partial(jax.jit, static_argnums=0, donate_argnums=(1, 2))
    def train_step(self, ts: RQMixState, buffer: EpisodeBuffer, key):
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
            return self._update_once(ts, buffer.sample(k, cfg.batch_episodes))

        keys = jax.random.split(jax.random.fold_in(key, 1), cfg.updates_per_iter)
        ts, aux = jax.lax.cond(
            buffer.size >= cfg.batch_episodes,
            lambda ts: jax.lax.scan(upd, ts, keys),
            lambda ts: (
                ts,
                {k: jnp.zeros(cfg.updates_per_iter) for k in ("q_loss", "q_tot")},
            ),
            ts,
        )
        metrics = {k: v.mean() for k, v in aux.items()}
        metrics["mean_step_reward"] = rews.mean()
        metrics["epsilon"] = self.epsilon(ts)
        metrics["buffer_episodes"] = buffer.size
        metrics.update({k: v.mean() for k, v in bench.items()})
        return ts, buffer, metrics
