"""MAPPO: multi-agent PPO with a centralized critic — the reference's
scalable on-policy path (``/root/reference/train/mappo/train_formation.py``,
tuned run ``train_formation.sh:13``: 128 rollout threads, episode_length 25,
ppo_epoch 10, lr 7e-4, value normalization, shared policy).

Design: the reference fans 128 env processes over pipes feeding a GPU
learner; here rollout collection (a ``lax.scan`` over the vmapped env
step) and the PPO update live in ONE jitted program, so the whole training
iteration is a single XLA executable.  The env batch shards over the mesh
'data' axis; gradients reduce over the mesh automatically via pjit.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
import optax
from ..core import struct

from ..env import FormationEnv, benchmark_means
from ..models.networks import (
    GaussianActor,
    LogitsActor,
    ValueCritic,
    categorical_entropy,
    categorical_logp,
    categorical_sample,
    gaussian_entropy,
    gaussian_logp,
    gaussian_sample,
    onehot_from_logits,
)

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class MAPPOConfig:
    """Defaults follow the reference tuned run (``train_formation.sh:13``) and
    onpolicy's MPE config (``train/mappo/inbox/config.py``)."""

    lr: float = 7e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ppo_epochs: int = 10
    num_minibatches: int = 1
    entropy_coef: float = 0.01
    value_coef: float = 1.0
    max_grad_norm: float = 10.0
    hidden: Tuple[int, ...] = (64, 64)
    rollout_len: int = 25
    use_value_norm: bool = True
    huber_delta: float = 10.0
    adam_eps: float = 1e-5
    # True = one policy/critic for all agents (the reference's shared runner);
    # False = per-agent stacked params (the separated runner,
    # ``train/mappo/train_formation.py:146-151``)
    share_policy: bool = True
    # Store O(N) state parts instead of the [T·B, N, 6N] observation tensor
    # and evaluate the actor/critic first layers factorized from them
    # (models/structured_obs.py — the hd observation is a linear repackaging
    # of state, so ``obs @ W`` needs no obs).  At N=243 this removes a
    # 4.5 GB trajectory tensor and ~45 G MACs/sample of first-layer work.
    # None = auto: ON for formation_hd_env + shared continuous policy +
    # all-silent agents + N >= 32 (below that the obs is small);
    # True/False force.
    structured_obs: Optional[bool] = None
    # Split each minibatch gradient into this many sequentially-accumulated
    # chunks (a lax.scan; chunk grads are averaged — exact up to f32
    # reassociation).  Divides the update's activation-backprop memory by
    # the chunk count at zero extra FLOPs.  Must divide
    # rollout_len*num_envs/num_minibatches.
    grad_accum: int = 1
    # Rematerialize the policy/critic forward in the update's backward
    # (jax.checkpoint around the loss forward): trades one extra forward
    # per epoch for not storing the [M, N, H] activations.  The alternative
    # memory lever to grad_accum.
    remat: bool = False
    # Automatic entropy-coefficient targeting: learn a SIGNED coefficient
    # α by gradient descent on  α · (entropy − target); the bonus weight
    # is stop_grad(clip(α, ±alpha_max)).  Unlike SAC's α = exp(·) ≥ 0,
    # α may go NEGATIVE — an entropy *penalty* — because in this
    # environment the pg gradient itself drives σ up (saturated-noise
    # bang-bang is locally attractive in the N=243 runs) and a
    # non-negative bonus can only stop helping, never push back
    # (α → 0 while entropy kept climbing, RESULTS.md).
    # α is stored as params['log_alpha'] (same Adam, no state-structure
    # change, checkpoints stay compatible per-config).
    auto_entropy: bool = False
    # |bonus weight| cap for auto_entropy, so the entropy term can never
    # dominate the normalized-advantage pg terms
    alpha_max: float = 0.05
    # target policy entropy in nats per agent; None = act_dim·(1.42 + ln 0.5)
    # (a diagonal Gaussian at σ = 0.5 per dim)
    entropy_target: Optional[float] = None
    # Run the structured actor's block einsums + MLP tail in bfloat16
    # (distribution params return in f32): the N=243 update is mostly
    # actor fwd+bwd, partly bound by memory traffic on [M, N, H] f32
    # activations — bf16 halves that traffic and the matrix-unit work.
    # A training-math change (~3 decimal digits on h1), so default OFF;
    # applied consistently to collection and update so the epoch-0 PPO
    # ratio stays 1.  structured_obs path only.  (The other f32 products of
    # the learners take the device's default matmul precision, which on an
    # H100 is TF32.)
    structured_bf16: bool = False


@struct.dataclass
class ValueNorm:
    """Running return normalizer (the reference's ``valuenorm``,
    ``train_formation.sh:13`` / ``maddpg-v4/utils.py`` PopArt-lite): critic
    learns in normalized space, GAE happens in raw space."""

    mean: Array
    mean_sq: Array
    count: Array

    @classmethod
    def create(cls):
        return cls(mean=jnp.zeros(()), mean_sq=jnp.ones(()), count=jnp.ones(()) * 1e-4)

    def update(self, x: Array) -> "ValueNorm":
        b_mean, b_sq, b_n = jnp.mean(x), jnp.mean(x**2), x.size
        n = self.count + b_n
        w = b_n / n
        return ValueNorm(
            mean=self.mean * (1 - w) + b_mean * w,
            mean_sq=self.mean_sq * (1 - w) + b_sq * w,
            count=n,
        )

    @property
    def std(self) -> Array:
        return jnp.sqrt(jnp.clip(self.mean_sq - self.mean**2, 1e-8))

    def normalize(self, x: Array) -> Array:
        return (x - self.mean) / self.std

    def denormalize(self, x: Array) -> Array:
        return x * self.std + self.mean


@struct.dataclass
class MAPPOState:
    params: dict  # {'actor': ..., 'critic': ...}
    opt_state: optax.OptState
    value_norm: ValueNorm
    update_i: Array


def huber(x: Array, delta: float) -> Array:
    a = jnp.abs(x)
    return jnp.where(a <= delta, 0.5 * x**2, delta * (a - 0.5 * delta))


class MAPPO:
    """Shared-policy MAPPO over a :class:`FormationEnv` batch.

    One :meth:`train_step` = collect ``rollout_len`` steps on ``num_envs``
    envs + ``ppo_epochs`` × ``num_minibatches`` PPO updates, fully jitted.
    """

    def __init__(self, env: FormationEnv, cfg: MAPPOConfig = MAPPOConfig(), num_envs: int = 128):
        self.env = env
        self.cfg = cfg
        self.num_envs = num_envs
        self.n_agents = env.num_agents
        self.obs_dim = env.scenario.obs_dim
        self.act_dim = env.act_dim
        # discrete envs get a categorical head (onpolicy's ACTLayer discrete
        # branch); continuous the diagonal Gaussian
        self.discrete = bool(env.discrete_action and not env.discrete_action_input)
        if self.discrete:
            self.actor = LogitsActor(self.act_dim, cfg.hidden)
        else:
            self.actor = GaussianActor(self.act_dim, cfg.hidden)
        self.critic = ValueCritic(cfg.hidden)
        so = cfg.structured_obs
        if so is None:
            so = (
                env.scenario.name == "formation_hd_env"
                and cfg.share_policy
                and not self.discrete
                and env._all_silent
                and env.scenario.obs_dim == 6 * self.n_agents
                and self.n_agents >= 32
            )
        self.structured_obs = bool(so)
        if self.structured_obs:
            assert (
                env.scenario.name == "formation_hd_env"
                and cfg.share_policy
                and not self.discrete
                and env._all_silent
            ), "structured_obs needs the hd obs layout + shared continuous policy"
        if cfg.auto_entropy:
            assert not self.discrete or cfg.entropy_target is not None, (
                "set an explicit entropy_target for categorical policies"
            )
        self.entropy_target = (
            cfg.entropy_target
            if cfg.entropy_target is not None
            else float(self.act_dim) * (1.41894 + float(np.log(0.5)))
        )
        self.tx = optax.chain(
            optax.clip_by_global_norm(cfg.max_grad_norm),
            optax.adam(cfg.lr, eps=cfg.adam_eps),
        )

    # -- setup --------------------------------------------------------------
    def init(self, key: Array):
        k_actor, k_critic, k_env = jax.random.split(key, 3)

        # One jitted program for the whole init instead of hundreds of
        # eager per-op dispatches.
        @jax.jit
        def _init(ka, kc):
            obs0 = jnp.zeros((1, self.obs_dim))
            sobs0 = jnp.zeros((1, self.obs_dim * self.n_agents))
            if self.cfg.share_policy:
                params = {
                    "actor": self.actor.init(ka, obs0),
                    "critic": self.critic.init(kc, sobs0),
                }
            else:
                params = {
                    "actor": jax.vmap(lambda k: self.actor.init(k, obs0))(
                        jax.random.split(ka, self.n_agents)
                    ),
                    "critic": jax.vmap(lambda k: self.critic.init(k, sobs0))(
                        jax.random.split(kc, self.n_agents)
                    ),
                }
            if self.cfg.auto_entropy:
                # α init: the fixed-coefficient default, adapted from there
                params["log_alpha"] = jnp.asarray(self.cfg.entropy_coef)
            return MAPPOState(
                params=params,
                opt_state=self.tx.init(params),
                value_norm=ValueNorm.create(),
                update_i=jnp.zeros((), jnp.int32),
            )

        ts = _init(k_actor, k_critic)
        env_state, obs = jax.jit(jax.vmap(self.env.reset))(
            jax.random.split(k_env, self.num_envs)
        )
        return ts, env_state, obs

    def _apply_actor(self, params, obs: Array):
        """obs [..., N, do] → dist params [..., N, da] ((mean, log_std) tuple
        for Gaussian, logits array for categorical), shared or per-agent
        stacked params."""
        if self.cfg.share_policy:
            return self.actor.apply(params, obs)
        return jax.vmap(self.actor.apply, in_axes=(0, -2), out_axes=-2)(
            params, obs
        )

    # distribution ops dispatched on the action-space kind
    def _dist_sample(self, key, dist):
        if self.discrete:
            return categorical_sample(key, dist)
        return gaussian_sample(key, *dist)

    def _dist_logp(self, dist, action):
        if self.discrete:
            return categorical_logp(dist, action)
        return gaussian_logp(*dist, action)

    def _dist_entropy(self, dist):
        if self.discrete:
            return jnp.mean(categorical_entropy(dist))
        return jnp.mean(gaussian_entropy(dist[1]))

    def _dist_mode(self, dist):
        return onehot_from_logits(dist) if self.discrete else dist[0]

    def _apply_critic(self, params, share_obs: Array):
        """share_obs [B, N·do] → value [B] (shared) or [B, N] (separated)."""
        if self.cfg.share_policy:
            return self.critic.apply(params, share_obs)
        v = jax.vmap(lambda p: self.critic.apply(p, share_obs))(params)  # [N, B]
        return jnp.moveaxis(v, 0, -1)

    def act(self, params, obs: Array, key=None, deterministic: bool = True) -> Array:
        dist = self._apply_actor(params["actor"], obs)
        if deterministic or key is None:
            return self._dist_mode(dist)
        return self._dist_sample(key, dist)

    # -- rollout ------------------------------------------------------------
    def _collect(self, ts: MAPPOState, env_state, obs, key):
        """lax.scan rollout: replaces the SubprocVecEnv collect loop
        (``onpolicy`` MPERunner.collect, SURVEY §3.5) with an on-device scan."""
        B, N = self.num_envs, self.n_agents

        def step_fn(carry, _):
            env_state, obs, key = carry
            key, k_act = jax.random.split(key)
            share_obs = obs.reshape(B, N * self.obs_dim)
            value = self._apply_critic(ts.params["critic"], share_obs)
            dist = self._apply_actor(ts.params["actor"], obs)  # [B,N,da]
            action = self._dist_sample(k_act, dist)
            logp = self._dist_logp(dist, action)  # [B,N]
            env_state, out = jax.vmap(self.env.step)(env_state, action)
            # share_obs is NOT stored: it is a reshape of obs, so the update
            # derives it from the minibatch (see _loss) instead of holding a
            # second [T·B, N·do] copy of the same bytes in device memory — at N=243
            # that copy alone is ~1.1 GB per 800-step trajectory and halved
            # the single-chip env ceiling (reference onpolicy's separate
            # share_obs buffer, train/mappo/train_formation.py:146-151, is a
            # CPU-RAM design choice this layout does not inherit).
            traj = {
                "obs": obs,
                "action": action,
                "logp": logp,
                "value": value,
                # env-level reward: agent 0's entry when the scenario shares
                # the reward (all entries identical), the agent mean otherwise
                # — a custom non-collaborative scenario must not silently
                # train every agent on agent 0's reward
                "reward": (
                    out.reward[:, 0]
                    if self.env.shared_reward
                    else out.reward.mean(axis=1)
                ),
                "done": out.done[:, 0],
            }
            return (env_state, out.obs, key), (traj, benchmark_means(out.info))

        (env_state, obs, key), (traj, bench) = jax.lax.scan(
            step_fn, (env_state, obs, key), None, length=self.cfg.rollout_len
        )
        last_value = self._apply_critic(
            ts.params["critic"], obs.reshape(B, N * self.obs_dim)
        )
        return env_state, obs, traj, bench, last_value

    def _parts(self, env_state):
        """O(N) state parts that linearly determine the hd observation."""
        n = self.n_agents
        return dict(
            apos=env_state.pos[:, :n],
            avel=env_state.vel[:, :n],
            ishape=env_state.ideal_shape,
            ivel=env_state.ideal_vel,
        )

    def _structured_dist_value(self, params, parts):
        from ..models.structured_obs import (
            actor_forward_structured,
            critic_forward_structured,
        )

        dist = actor_forward_structured(
            params["actor"], parts["apos"], parts["avel"],
            parts["ishape"], parts["ivel"], self.cfg.hidden,
            dtype=jnp.bfloat16 if self.cfg.structured_bf16 else None,
        )
        value = critic_forward_structured(
            params["critic"], parts["apos"], parts["avel"],
            parts["ishape"], parts["ivel"], self.cfg.hidden,
        )
        return dist, value

    def _collect_structured(self, ts: MAPPOState, env_state, obs, key):
        """Obs-free collection: the trajectory stores the O(N) state parts
        the hd observation is a linear function of; nothing consumes
        ``out.obs``, so XLA dead-code-eliminates the [B, N, 6N] observation
        construction inside the env step entirely."""

        def step_fn(carry, _):
            env_state, key = carry
            key, k_act = jax.random.split(key)
            parts = self._parts(env_state)
            dist, value = self._structured_dist_value(ts.params, parts)
            action = self._dist_sample(k_act, dist)
            logp = self._dist_logp(dist, action)
            env_state, out = jax.vmap(self.env.step)(env_state, action)
            traj = dict(
                parts,
                action=action,
                logp=logp,
                value=value,
                reward=(
                    out.reward[:, 0]
                    if self.env.shared_reward
                    else out.reward.mean(axis=1)
                ),
                done=out.done[:, 0],
            )
            return (env_state, key), (traj, benchmark_means(out.info))

        (env_state, key), (traj, bench) = jax.lax.scan(
            step_fn, (env_state, key), None, length=self.cfg.rollout_len
        )
        _, last_value = self._structured_dist_value(
            ts.params, self._parts(env_state)
        )
        # obs passes through untouched (aliased): the structured path never
        # materializes it, but the train_step interface threads it
        return env_state, obs, traj, bench, last_value

    def _gae(self, ts: MAPPOState, traj, last_value):
        """GAE over the scan axis, in *raw* return space (values are stored in
        normalized space when value_norm is on)."""
        vn = ts.value_norm
        values = traj["value"]
        if self.cfg.use_value_norm:
            values = vn.denormalize(values)
            last_value = vn.denormalize(last_value)
        gamma, lam = self.cfg.gamma, self.cfg.gae_lambda
        reward, done = traj["reward"], traj["done"]
        if values.ndim == 3:  # separated critics: per-agent value axis
            reward = reward[..., None]
            done = done[..., None]

        def scan_fn(carry, inp):
            gae, next_value = carry
            reward, value, done = inp
            nonterm = 1.0 - done.astype(value.dtype)
            delta = reward + gamma * next_value * nonterm - value
            gae = delta + gamma * lam * nonterm * gae
            return (gae, value), gae

        (_, _), adv = jax.lax.scan(
            scan_fn,
            (jnp.zeros_like(last_value), last_value),
            (reward, values, done),
            reverse=True,
        )
        returns = adv + values
        return adv, returns

    # -- update -------------------------------------------------------------
    def _loss(self, params, batch, vn: ValueNorm):
        cfg = self.cfg
        if "obs" in batch:
            obs = batch["obs"]
            dist = self._apply_actor(params["actor"], obs)  # [M,N,da]
            value = None
        else:  # structured path: state parts instead of observations
            dist, value = self._structured_dist_value(params, batch)
        logp = self._dist_logp(dist, batch["action"])  # [M,N]
        # clamp the log-ratio: a policy far from the behavior policy after
        # many epochs otherwise overflows exp() into inf/NaN gradients
        ratio = jnp.exp(jnp.clip(logp - batch["logp"], -20.0, 20.0))
        adv = batch["adv"]
        if adv.ndim == 1:
            adv = adv[:, None]  # env-level advantage → all agents
        pg1 = ratio * adv
        pg2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        pg_loss = -jnp.mean(jnp.minimum(pg1, pg2))
        entropy = self._dist_entropy(dist)

        if value is None:
            # derived, not stored: identical bytes to rollout-time share_obs
            share_obs = obs.reshape(obs.shape[0], -1)
            value = self._apply_critic(params["critic"], share_obs)
        target = batch["target"]
        v_old = batch["value"]
        v_clip = v_old + jnp.clip(value - v_old, -cfg.clip_eps, cfg.clip_eps)
        v_loss = jnp.mean(
            jnp.maximum(
                huber(value - target, cfg.huber_delta),
                huber(v_clip - target, cfg.huber_delta),
            )
        )
        if cfg.auto_entropy:
            alpha_raw = params["log_alpha"]  # raw SIGNED coefficient
            coef = jax.lax.stop_gradient(
                jnp.clip(alpha_raw, -cfg.alpha_max, cfg.alpha_max)
            )
            # descent on α · (H − H*): α falls while H > H* (through zero
            # into a penalty), rises while H < H*
            alpha_loss = alpha_raw * (
                jax.lax.stop_gradient(entropy) - self.entropy_target
            )
            ent_term = coef * entropy - alpha_loss
        else:
            ent_term = cfg.entropy_coef * entropy
        total = pg_loss - ent_term + cfg.value_coef * v_loss
        approx_kl = jnp.mean(batch["logp"] - logp)
        metrics = {
            "pg_loss": pg_loss,
            "v_loss": v_loss,
            "entropy": entropy,
            "approx_kl": approx_kl,
        }
        if cfg.auto_entropy:
            metrics["alpha"] = params["log_alpha"]
        return total, metrics

    def _update(self, ts: MAPPOState, data, key):
        cfg = self.cfg
        M = cfg.rollout_len * self.num_envs
        mb = M // cfg.num_minibatches

        loss_fn = self._loss
        if cfg.remat:
            # backward recomputes the forward instead of holding the
            # [M, N, H] activations across the loss — see MAPPOConfig.remat
            loss_fn = jax.checkpoint(loss_fn)
        grad_fn = jax.grad(loss_fn, has_aux=True)

        def batch_grads(ts, batch):
            if cfg.grad_accum <= 1:
                return grad_fn(ts.params, batch, ts.value_norm)
            K = cfg.grad_accum
            m = batch["action"].shape[0]
            assert m % K == 0, (m, K)
            chunks = jax.tree.map(
                lambda x: x.reshape((K, m // K) + x.shape[1:]), batch
            )

            def acc_fn(carry, chunk):
                gsum, msum = carry
                g, met = grad_fn(ts.params, chunk, ts.value_norm)
                return (
                    jax.tree.map(jnp.add, gsum, g),
                    jax.tree.map(jnp.add, msum, met),
                ), None

            zg = jax.tree.map(jnp.zeros_like, ts.params)
            mkeys = ("pg_loss", "v_loss", "entropy", "approx_kl") + (
                ("alpha",) if cfg.auto_entropy else ()
            )
            zm = {k: jnp.zeros(()) for k in mkeys}
            (gsum, msum), _ = jax.lax.scan(acc_fn, (zg, zm), chunks)
            inv = 1.0 / K  # equal chunks: mean of chunk-means = global mean
            return (
                jax.tree.map(lambda g: g * inv, gsum),
                jax.tree.map(lambda v: v * inv, msum),
            )

        def do_update(ts, batch):
            grads, metrics = batch_grads(ts, batch)
            updates, opt_state = self.tx.update(grads, ts.opt_state, ts.params)
            params = optax.apply_updates(ts.params, updates)
            return ts.replace(params=params, opt_state=opt_state), metrics

        def epoch_fn(carry, k_epoch):
            ts = carry
            if cfg.num_minibatches == 1:
                # single minibatch: shuffling is a no-op for the gradient, and
                # the permutation gather would materialize a full trajectory
                # copy (≈4.5 GB at N=243 × 128 envs) — use the data in place
                return do_update(ts, data)
            perm = jax.random.permutation(k_epoch, M)

            def mb_fn(ts, idx):
                return do_update(ts, jax.tree.map(lambda x: x[idx], data))

            ts, metrics = jax.lax.scan(
                mb_fn, ts, perm.reshape(cfg.num_minibatches, mb)
            )
            return ts, metrics

        ts, metrics = jax.lax.scan(
            epoch_fn, ts, jax.random.split(key, cfg.ppo_epochs)
        )
        metrics = jax.tree.map(jnp.mean, metrics)
        return ts, metrics

    def _prepare(self, ts: MAPPOState, traj, last_value):
        """GAE + value-norm + flattening: turns a trajectory into the flat
        update batch (the phase between collect and the PPO epochs)."""
        cfg = self.cfg
        adv, returns = self._gae(ts, traj, last_value)

        vn = ts.value_norm
        if cfg.use_value_norm:
            vn = vn.update(returns)
            target = vn.normalize(returns)
        else:
            target = returns
        ts = ts.replace(value_norm=vn)

        adv_n = (adv - adv.mean()) / (adv.std() + 1e-5)
        flat = lambda x: x.reshape((cfg.rollout_len * self.num_envs,) + x.shape[2:])
        keys = (
            ("apos", "avel", "ishape", "ivel")
            if self.structured_obs
            else ("obs",)
        ) + ("action", "logp", "value")
        data = {k: flat(traj[k]) for k in keys}
        data["adv"] = flat(adv_n)
        data["target"] = flat(target)
        return ts, data

    # -- public api ---------------------------------------------------------
    @partial(jax.jit, static_argnums=0, donate_argnums=(1, 2))
    def train_step(self, ts: MAPPOState, env_state, obs, key):
        """One full MAPPO iteration (collect + GAE + PPO epochs), jitted."""
        cfg = self.cfg
        k_roll, k_upd = jax.random.split(key)
        collect = self._collect_structured if self.structured_obs else self._collect
        env_state, obs, traj, bench, last_value = collect(
            ts, env_state, obs, k_roll
        )
        ts, data = self._prepare(ts, traj, last_value)
        ts, metrics = self._update(ts, data, k_upd)
        metrics["mean_step_reward"] = jnp.mean(traj["reward"])
        metrics.update({k: v.mean() for k, v in bench.items()})
        ts = ts.replace(update_i=ts.update_i + 1)
        return ts, env_state, obs, metrics
