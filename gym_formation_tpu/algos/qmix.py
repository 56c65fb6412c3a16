"""QMIX / VDN: discrete-action value factorization with a (monotonic) mixer.

Completes the discrete off-policy surface of the reference zoo
(``/root/reference/train/maddpg-v5/train.py:41-56`` + ``config.py:4-194``:
``qmix``/``vdn``/``mqmix``/``mvdn`` with mixer embed dims, eps-greedy anneal,
soft/hard target updates).  Uses the env's 5-way discrete action head
(``environment.py:64-65``).

Design: one shared per-agent Q-network (agent-id one-hot appended to the
obs, the shared-policy trick of the reference's offpolicy/maddpg-v4 stack)
applied to all agents in one batched matmul; the QMIX hypernetwork mixes the
chosen Q's under the centralized state.  Collect + update is one jitted
program, buffer on device.
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
from .maddpg import ReplayBuffer

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class QMixConfig:
    mixer: str = "qmix"  # 'qmix' | 'vdn'
    lr: float = 5e-4
    gamma: float = 0.99
    tau: float = 0.005  # soft target update (hard update if hard_interval > 0)
    hard_interval: int = 0
    buffer_size: int = 200_000
    batch_size: int = 256
    hidden: Tuple[int, ...] = (64, 64)
    mixer_embed: int = 32  # reference qmix mixer dims (maddpg-v5/config.py)
    eps_start: float = 1.0
    eps_finish: float = 0.05
    eps_anneal_steps: int = 50_000
    double_q: bool = True
    mask_done: bool = False
    steps_per_iter: int = 32
    updates_per_iter: int = 8


class AgentQNet(nn.Module):
    """Shared Q-network over (obs ⊕ one-hot agent id) → Q per action."""

    n_actions: int
    hidden: Tuple[int, ...] = (64, 64)

    @nn.compact
    def __call__(self, x: Array) -> Array:
        h = MLP(self.hidden)(x)
        return nn.Dense(self.n_actions, kernel_init=orthogonal_init(0.01))(h)


class QMixer(nn.Module):
    """Monotonic mixing hypernetwork (Rashid et al. 2018): per-agent chosen
    Q's are mixed with state-conditioned positive weights."""

    n_agents: int
    embed: int = 32

    @nn.compact
    def __call__(self, q_chosen: Array, state: Array) -> Array:
        # q_chosen: [M, N]; state: [M, ds]
        w1 = jnp.abs(nn.Dense(self.n_agents * self.embed)(state)).reshape(
            -1, self.n_agents, self.embed
        )
        b1 = nn.Dense(self.embed)(state)
        hidden = nn.elu(jnp.einsum("mn,mne->me", q_chosen, w1) + b1)
        w2 = jnp.abs(nn.Dense(self.embed)(state))
        b2 = nn.Dense(1, kernel_init=orthogonal_init(1.0))(
            nn.relu(nn.Dense(self.embed)(state))
        )
        return jnp.sum(hidden * w2, axis=-1) + b2.squeeze(-1)


@struct.dataclass
class QMixState:
    q_params: dict
    mixer_params: dict  # empty dict for VDN
    target_q_params: dict
    target_mixer_params: dict
    opt_state: optax.OptState
    env_steps: Array
    grad_updates: Array


class QMix:
    """Trainer for both QMIX (hypernet mixer) and VDN (sum mixer)."""

    N_ACTIONS = 5  # Discrete(dim_p*2+1), environment.py:65

    def __init__(
        self, env: FormationEnv, cfg: QMixConfig = QMixConfig(), num_envs: int = 32
    ):
        assert env.discrete_action, "QMix requires a discrete_action env"
        self.env = env
        self.cfg = cfg
        self.num_envs = num_envs
        self.n_agents = env.num_agents
        self.obs_dim = env.scenario.obs_dim
        self.qnet = AgentQNet(self.N_ACTIONS, cfg.hidden)
        self.mixer = QMixer(self.n_agents, cfg.mixer_embed)
        self.tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(cfg.lr))
        self._agent_ids = np.eye(self.n_agents, dtype=np.float32)

    # -- q-net over all agents ---------------------------------------------
    def _q_all(self, params, obs: Array) -> Array:
        """obs [..., N, do] → Q [..., N, A] via shared net + id one-hot."""
        ids = jnp.broadcast_to(
            jnp.asarray(self._agent_ids), obs.shape[:-1] + (self.n_agents,)
        )
        return self.qnet.apply(params, jnp.concatenate([obs, ids], axis=-1))

    def init(self, key: Array):
        cfg = self.cfg
        kq, km, k_env = jax.random.split(key, 3)

        @jax.jit
        def _init(kq, km):
            x0 = jnp.zeros((1, self.obs_dim + self.n_agents))
            q_params = self.qnet.init(kq, x0)
            if cfg.mixer == "qmix":
                mixer_params = self.mixer.init(
                    km,
                    jnp.zeros((1, self.n_agents)),
                    jnp.zeros((1, self.obs_dim * self.n_agents)),
                )
            else:
                mixer_params = {}
            params = {"q": q_params, "mixer": mixer_params}
            return QMixState(
                q_params=q_params,
                mixer_params=mixer_params,
                target_q_params=jax.tree.map(lambda x: x + 0, q_params),
                target_mixer_params=jax.tree.map(lambda x: x + 0, mixer_params),
                opt_state=self.tx.init(params),
                env_steps=jnp.zeros((), jnp.int32),
                grad_updates=jnp.zeros((), jnp.int32),
            )

        ts = _init(kq, km)
        # action stored as one-hot (what the env consumes)
        buffer = ReplayBuffer.create(
            cfg.buffer_size, self.n_agents, self.obs_dim, self.N_ACTIONS
        )
        # jit: eager vmapped reset is pathological on remote backends
        env_state, obs = jax.jit(jax.vmap(self.env.reset))(
            jax.random.split(k_env, self.num_envs)
        )
        return ts, buffer, env_state, obs

    def epsilon(self, ts: QMixState) -> Array:
        """Linear decay-then-flat schedule (``maddpg-v4/utils.py``
        DecayThenFlatSchedule / v5 eps-greedy anneal flags)."""
        cfg = self.cfg
        frac = jnp.clip(ts.env_steps / cfg.eps_anneal_steps, 0.0, 1.0)
        return cfg.eps_start + (cfg.eps_finish - cfg.eps_start) * frac

    def explore_actions(self, ts: QMixState, obs: Array, key) -> Array:
        """ε-greedy over Q, returned one-hot for the env."""
        k_eps, k_uni = jax.random.split(key)
        q = self._q_all(ts.q_params, obs)  # [B,N,A]
        greedy = jnp.argmax(q, axis=-1)
        rand = jax.random.randint(k_uni, greedy.shape, 0, self.N_ACTIONS)
        pick = jnp.where(
            jax.random.uniform(k_eps, greedy.shape) < self.epsilon(ts), rand, greedy
        )
        return jax.nn.one_hot(pick, self.N_ACTIONS, dtype=obs.dtype)

    def _mix(self, mixer_params, q_chosen: Array, state: Array) -> Array:
        if self.cfg.mixer == "qmix":
            return self.mixer.apply(mixer_params, q_chosen, state)
        return jnp.sum(q_chosen, axis=-1)  # VDN

    def _loss(self, params, ts: QMixState, batch):
        cfg = self.cfg
        M = batch["obs"].shape[0]
        state = batch["obs"].reshape(M, -1)
        next_state = batch["next_obs"].reshape(M, -1)
        act_idx = jnp.argmax(batch["action"], axis=-1)  # [M,N]
        q = self._q_all(params["q"], batch["obs"])  # [M,N,A]
        q_chosen = jnp.take_along_axis(q, act_idx[..., None], axis=-1).squeeze(-1)
        q_tot = self._mix(params["mixer"], q_chosen, state)

        q_next_target = self._q_all(ts.target_q_params, batch["next_obs"])
        if cfg.double_q:
            sel = jnp.argmax(self._q_all(params["q"], batch["next_obs"]), axis=-1)
        else:
            sel = jnp.argmax(q_next_target, axis=-1)
        qn_chosen = jnp.take_along_axis(
            q_next_target, sel[..., None], axis=-1
        ).squeeze(-1)
        q_tot_next = self._mix(ts.target_mixer_params, qn_chosen, next_state)
        # shared reward: all agents equal, use agent 0's (environment.py:135-138)
        r = batch["reward"][:, 0]
        nonterm = (1.0 - batch["done"].astype(r.dtype)) if cfg.mask_done else 1.0
        y = jax.lax.stop_gradient(r + cfg.gamma * q_tot_next * nonterm)
        loss = jnp.mean((y - q_tot) ** 2)
        return loss, {"q_loss": loss, "q_tot": jnp.mean(q_tot)}

    def _update_once(self, ts: QMixState, batch):
        cfg = self.cfg
        params = {"q": ts.q_params, "mixer": ts.mixer_params}
        grads, aux = jax.grad(self._loss, has_aux=True)(params, ts, batch)
        updates, opt_state = self.tx.update(grads, ts.opt_state, params)
        new_params = optax.apply_updates(params, updates)
        gu = ts.grad_updates + 1
        if cfg.hard_interval > 0:
            do_hard = gu % cfg.hard_interval == 0
            upd_t = lambda t, p: jax.tree.map(
                lambda a, b: jnp.where(do_hard, b, a), t, p
            )
        else:
            upd_t = lambda t, p: jax.tree.map(
                lambda a, b: (1 - cfg.tau) * a + cfg.tau * b, t, p
            )
        return (
            ts.replace(
                q_params=new_params["q"],
                mixer_params=new_params["mixer"],
                target_q_params=upd_t(ts.target_q_params, new_params["q"]),
                target_mixer_params=upd_t(ts.target_mixer_params, new_params["mixer"]),
                opt_state=opt_state,
                grad_updates=gu,
            ),
            aux,
        )

    @partial(jax.jit, static_argnums=0, donate_argnums=(1, 2, 3, 4))
    def train_step(self, ts: QMixState, buffer: ReplayBuffer, env_state, obs, key):
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
            return self._update_once(ts, buffer.sample(k, cfg.batch_size))

        keys = jax.random.split(jax.random.fold_in(key, 1), cfg.updates_per_iter)
        ts, aux = jax.lax.cond(
            buffer.size >= cfg.batch_size,
            lambda ts: jax.lax.scan(upd, ts, keys),
            lambda ts: (
                ts,
                {k: jnp.zeros(cfg.updates_per_iter) for k in ("q_loss", "q_tot")},
            ),
            ts,
        )
        metrics = {k: v.mean() for k, v in aux.items()}
        metrics["mean_step_reward"] = step_rew.mean()
        metrics["epsilon"] = self.epsilon(ts)
        metrics.update({k: v.mean() for k, v in bench.items()})
        return ts, buffer, env_state, obs, metrics

    def eval_actions(self, ts: QMixState, obs: Array) -> Array:
        q = self._q_all(ts.q_params, obs)
        return jax.nn.one_hot(jnp.argmax(q, axis=-1), self.N_ACTIONS, dtype=obs.dtype)
