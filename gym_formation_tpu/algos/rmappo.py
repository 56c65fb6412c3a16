"""RMAPPO: recurrent MAPPO with GRU actor/critic and chunked BPTT.

The reference's tuned configuration is ``--algorithm_name rmappo``
(``/root/reference/train/mappo/train_formation.sh:13``); recurrence is the
``use_recurrent_policy`` path of onpolicy with ``data_chunk_length`` BPTT
chunks (documented in ``train/mappo/inbox/config.py``; the offpolicy zoo uses
chunk length 80, ``train/maddpg-v5/config.py:89-90``).

Design: the rollout scan threads GRU carries alongside env state (carries
zeroed at episode starts *inside* the jit), and the PPO update BPTT-scans
fixed-length chunks whose initial hidden states were recorded during
collection — every step is static-shaped and the whole iteration remains one
XLA program.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import optax
from ..core import struct

from ..env import FormationEnv, benchmark_means
from ..models.flax_networks import GRUCritic, GRUPolicy
from .mappo import MAPPO, MAPPOConfig, MAPPOState, ValueNorm, huber

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class RMAPPOConfig(MAPPOConfig):
    gru_hidden: int = 64
    data_chunk_length: int = 5  # BPTT chunk (onpolicy data_chunk_length)


@struct.dataclass
class RunnerCarry:
    """Cross-iteration recurrent state: GRU carries + last done flags."""

    h_actor: Array  # [B, N, H]
    h_critic: Array  # [B, H]
    done_prev: Array  # [B] bool


class RMAPPO(MAPPO):
    def __init__(
        self, env: FormationEnv, cfg: RMAPPOConfig = RMAPPOConfig(), num_envs: int = 128
    ):
        super().__init__(env, cfg, num_envs)
        assert cfg.rollout_len % cfg.data_chunk_length == 0
        # self.discrete set by MAPPO.__init__; the GRU policy switches heads
        self.actor = GRUPolicy(self.act_dim, cfg.gru_hidden, discrete=self.discrete)
        self.critic = GRUCritic(cfg.gru_hidden)

    def init(self, key: Array):
        cfg = self.cfg
        k_actor, k_critic, k_env = jax.random.split(key, 3)
        B, N = self.num_envs, self.n_agents

        @jax.jit
        def _init(ka, kc):
            obs0 = jnp.zeros((1, self.obs_dim))
            sobs0 = jnp.zeros((1, self.obs_dim * N))
            h0a = jnp.zeros((1, cfg.gru_hidden))
            r0 = jnp.zeros((1,), bool)
            params = {
                "actor": self.actor.init(ka, h0a, obs0, r0),
                "critic": self.critic.init(kc, h0a, sobs0, r0),
            }
            return MAPPOState(
                params=params,
                opt_state=self.tx.init(params),
                value_norm=ValueNorm.create(),
                update_i=jnp.zeros((), jnp.int32),
            )

        ts = _init(k_actor, k_critic)
        # jit: eager vmapped reset is pathological on remote backends
        env_state, obs = jax.jit(jax.vmap(self.env.reset))(jax.random.split(k_env, B))
        carry = RunnerCarry(
            h_actor=jnp.zeros((B, N, cfg.gru_hidden)),
            h_critic=jnp.zeros((B, cfg.gru_hidden)),
            done_prev=jnp.zeros((B,), bool),
        )
        return ts, env_state, obs, carry

    def act(self, params, obs, carry: RunnerCarry, key=None, deterministic=True):
        """Recurrent action selection for eval: returns (actions, new carry)."""
        reset_n = jnp.broadcast_to(carry.done_prev[:, None], obs.shape[:2])
        h_a, dist = self.actor.apply(
            params["actor"], carry.h_actor, obs, reset_n
        )
        if deterministic or key is None:
            a = self._dist_mode(dist)
        else:
            a = self._dist_sample(key, dist)
        return a, carry.replace(h_actor=h_a, done_prev=jnp.zeros_like(carry.done_prev))

    # -- rollout ------------------------------------------------------------
    def _collect_recurrent(self, ts, env_state, obs, carry: RunnerCarry, key):
        B, N = self.num_envs, self.n_agents

        def step_fn(c, _):
            env_state, obs, carry, key = c
            key, k_act = jax.random.split(key)
            share_obs = obs.reshape(B, N * self.obs_dim)
            reset = carry.done_prev
            reset_n = jnp.broadcast_to(reset[:, None], (B, N))
            h_c, value = self.critic.apply(
                ts.params["critic"], carry.h_critic, share_obs, reset
            )
            h_a, dist = self.actor.apply(
                ts.params["actor"], carry.h_actor, obs, reset_n
            )
            action = self._dist_sample(k_act, dist)
            logp = self._dist_logp(dist, action)
            env_state, out = jax.vmap(self.env.step)(env_state, action)
            done = out.done[:, 0]
            # share_obs is NOT stored — it is a reshape of obs, re-derived in
            # _loss (same memory-halving rationale as MAPPO._collect)
            traj = {
                "obs": obs,
                "action": action,
                "logp": logp,
                "value": value,
                # env-level reward (mean when the scenario is non-collaborative
                # — see MAPPO._collect)
                "reward": (
                    out.reward[:, 0]
                    if self.env.shared_reward
                    else out.reward.mean(axis=1)
                ),
                "done": done,
                "reset": reset,  # hidden-reset flag used at this step
                "h_actor": carry.h_actor,  # pre-step carries (chunk inits)
                "h_critic": carry.h_critic,
            }
            new_carry = RunnerCarry(h_actor=h_a, h_critic=h_c, done_prev=done)
            return (env_state, obs := out.obs, new_carry, key), (
                traj,
                benchmark_means(out.info),
            )

        (env_state, obs, carry, key), (traj, bench) = jax.lax.scan(
            step_fn, (env_state, obs, carry, key), None, length=self.cfg.rollout_len
        )
        _, last_value = self.critic.apply(
            ts.params["critic"],
            carry.h_critic,
            obs.reshape(B, N * self.obs_dim),
            carry.done_prev,
        )
        return env_state, obs, carry, traj, bench, last_value

    # -- recurrent loss over one BPTT chunk ---------------------------------
    def _loss(self, params, batch, vn):
        """batch leaves: [L, m, ...] chunks + h0 inits [m, ...]."""
        cfg = self.cfg

        def scan_net(c, inp):
            h_a, h_c = c
            obs, reset = inp["obs"], inp["reset"]
            sobs = obs.reshape(obs.shape[0], -1)  # derived, not stored
            reset_n = jnp.broadcast_to(reset[:, None], obs.shape[:2])
            h_a, dist = self.actor.apply(params["actor"], h_a, obs, reset_n)
            h_c, value = self.critic.apply(params["critic"], h_c, sobs, reset)
            return (h_a, h_c), (dist, value)

        (_, _), (dist, value) = jax.lax.scan(
            scan_net,
            (batch["h_actor0"], batch["h_critic0"]),
            {k: batch[k] for k in ("obs", "reset")},
        )
        logp = self._dist_logp(dist, batch["action"])  # [L,m,N]
        # clamp the log-ratio: a policy far from the behavior policy after
        # many epochs otherwise overflows exp() into inf/NaN gradients
        ratio = jnp.exp(jnp.clip(logp - batch["logp"], -20.0, 20.0))
        adv = batch["adv"][..., None]
        pg1 = ratio * adv
        pg2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        pg_loss = -jnp.mean(jnp.minimum(pg1, pg2))
        entropy = self._dist_entropy(dist)
        target, v_old = batch["target"], batch["value"]
        v_clip = v_old + jnp.clip(value - v_old, -cfg.clip_eps, cfg.clip_eps)
        v_loss = jnp.mean(
            jnp.maximum(
                huber(value - target, cfg.huber_delta),
                huber(v_clip - target, cfg.huber_delta),
            )
        )
        total = pg_loss - cfg.entropy_coef * entropy + cfg.value_coef * v_loss
        return total, {
            "pg_loss": pg_loss,
            "v_loss": v_loss,
            "entropy": entropy,
            "approx_kl": jnp.mean(batch["logp"] - logp),
        }

    def _update_recurrent(self, ts, data, key):
        """Minibatches over (chunk × env) samples, each a [L, ...] BPTT scan."""
        cfg = self.cfg
        L = cfg.data_chunk_length
        K = cfg.rollout_len // L
        M = K * self.num_envs  # number of chunks
        mb = M // cfg.num_minibatches

        # [T,B,...] → [K, L, B, ...] → [L, K*B, ...]
        def chunk(x):
            return (
                x.reshape((K, L, self.num_envs) + x.shape[2:])
                .swapaxes(0, 1)
                .reshape((L, M) + x.shape[2:])
            )

        # chunk-start hiddens: element [k*L, b] → [K*B, ...]
        def inits(x):
            return x.reshape((K, L, self.num_envs) + x.shape[2:])[:, 0].reshape(
                (M,) + x.shape[2:]
            )

        chunked = {
            k: chunk(data[k])
            for k in (
                "obs", "action", "logp", "value", "adv",
                "target", "reset",
            )
        }
        chunked["h_actor0"] = inits(data["h_actor"])
        chunked["h_critic0"] = inits(data["h_critic"])

        def do_update(ts, batch):
            grads, metrics = jax.grad(self._loss, has_aux=True)(
                ts.params, batch, ts.value_norm
            )
            updates, opt_state = self.tx.update(grads, ts.opt_state, ts.params)
            return (
                ts.replace(
                    params=optax.apply_updates(ts.params, updates),
                    opt_state=opt_state,
                ),
                metrics,
            )

        def epoch_fn(ts, k_epoch):
            if cfg.num_minibatches == 1:
                # single minibatch: shuffling chunks is a gradient no-op and
                # the permutation gather would copy the full chunked
                # trajectory every epoch (see MAPPO._update)
                return do_update(ts, chunked)
            perm = jax.random.permutation(k_epoch, M)

            def mb_fn(ts, idx):
                batch = {
                    k: (v[idx] if k.endswith("0") else v[:, idx])
                    for k, v in chunked.items()
                }
                return do_update(ts, batch)

            return jax.lax.scan(mb_fn, ts, perm.reshape(cfg.num_minibatches, mb))

        ts, metrics = jax.lax.scan(epoch_fn, ts, jax.random.split(key, cfg.ppo_epochs))
        return ts, jax.tree.map(jnp.mean, metrics)

    # -- public -------------------------------------------------------------
    @partial(jax.jit, static_argnums=0, donate_argnums=(1, 2, 3, 4))
    def train_step(self, ts, env_state, obs, carry: RunnerCarry, key):
        cfg = self.cfg
        k_roll, k_upd = jax.random.split(key)
        env_state, obs, carry, traj, bench, last_value = self._collect_recurrent(
            ts, env_state, obs, carry, k_roll
        )
        adv, returns = self._gae(ts, traj, last_value)
        vn = ts.value_norm
        if cfg.use_value_norm:
            vn = vn.update(returns)
            target = vn.normalize(returns)
        else:
            target = returns
        ts = ts.replace(value_norm=vn)
        adv_n = (adv - adv.mean()) / (adv.std() + 1e-5)
        data = dict(traj)
        data["adv"] = adv_n
        data["target"] = target
        ts, metrics = self._update_recurrent(ts, data, k_upd)
        metrics["mean_step_reward"] = jnp.mean(traj["reward"])
        metrics.update({k: v.mean() for k, v in bench.items()})
        ts = ts.replace(update_i=ts.update_i + 1)
        return ts, env_state, obs, carry, metrics
