"""MADDPG: centralized-critic DDPG — the reference's converging baseline
(``/root/reference/train/maddpg-v1/``: per-agent actor/critic + targets,
centralized critic over all obs+actions, ε-greedy uniform exploration with
Gaussian action noise, soft target updates; hyperparameters from
``common/arguments.py:9-39``).

Design: the reference loops one env step and N sequential
per-agent torch updates on CPU (``runner.py:31-54``); here all N agents'
networks are ONE stacked parameter pytree (leading agent axis, built with
``vmap(init)``) and every update trains all agents simultaneously with a
single vmapped gradient — the per-agent matmuls batch into one product.  The
replay buffer lives in device memory and env interaction + updates run in one
jitted program.

Faithful quirks kept (flag-gated): TD target without a done mask
(``maddpg/maddpg.py:82``, SURVEY §8.4; ``mask_done=True`` restores the
standard target), linear noise/epsilon decay ``-5e-7/step`` to 0.05
(``runner.py:62-63``).
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
from ..models.flax_networks import CentralizedQCritic, DeterministicActor
from ..models.networks import LogitsActor, gumbel_softmax_st, onehot_from_logits

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class MADDPGConfig:
    lr_actor: float = 1e-4
    lr_critic: float = 1e-4
    epsilon: float = 0.1
    noise_rate: float = 0.25
    explore_decay: float = 5e-7
    explore_min: float = 0.05
    # Ornstein-Uhlenbeck exploration noise — the reference v2 continuous-
    # action default (``maddpg-v2/utils/noise.py:5-22``, ``utils/agents.py``):
    # x += theta*(mu - x) + sigma*N(0,1); action += x*scale, with the scale
    # annealed like v2's ``scale_noise`` (here: the decaying ``noise`` state)
    # and x reset to mu at episode boundaries.  False = v1 Gaussian noise.
    ou_noise: bool = False
    ou_theta: float = 0.15
    ou_sigma: float = 0.2
    ou_mu: float = 0.0
    gamma: float = 0.95
    tau: float = 0.01
    buffer_size: int = 500_000
    batch_size: int = 256
    hidden: Tuple[int, ...] = (64, 64, 64)
    high_action: float = 1.0
    mask_done: bool = False  # v1 semantics: no done mask in the TD target
    # Prioritized replay (reference v4 PER: alpha .6, beta .4 anneal,
    # ``maddpg-v4/parameters.yaml`` / ``replaybuffer.py:246-394``)
    use_per: bool = False
    per_alpha: float = 0.6
    per_beta0: float = 0.4
    per_beta_anneal: int = 100_000
    # centralized critic Q(all obs, all acts) = MADDPG; False = per-agent
    # local critic Q(o_i, u_i) = the DDPG alg_type of the reference v2 zoo
    # (``maddpg-v2/algorithms/maddpg.py:99-127``)
    centralized: bool = True
    steps_per_iter: int = 32  # env steps collected per train_step call
    updates_per_iter: int = 32  # gradient updates per train_step call


@struct.dataclass
class ReplayBuffer:
    """Device-resident ring buffer, transitions batched over envs.

    Replaces the host dict-of-arrays buffer with threading.Lock
    (``maddpg-v1/common/replay_buffer.py:5-54``); a ring overwrite stands in
    for the reference's random-overwrite-when-full.
    """

    obs: Array  # [cap, N, do]
    action: Array  # [cap, N, da]
    reward: Array  # [cap, N]
    next_obs: Array  # [cap, N, do]
    done: Array  # [cap]
    ptr: Array  # i32
    size: Array  # i32

    @classmethod
    def create(cls, cap: int, n_agents: int, obs_dim: int, act_dim: int):
        return cls(
            obs=jnp.zeros((cap, n_agents, obs_dim)),
            action=jnp.zeros((cap, n_agents, act_dim)),
            reward=jnp.zeros((cap, n_agents)),
            next_obs=jnp.zeros((cap, n_agents, obs_dim)),
            done=jnp.zeros((cap,), bool),
            ptr=jnp.zeros((), jnp.int32),
            size=jnp.zeros((), jnp.int32),
        )

    def insert(self, obs, action, reward, next_obs, done) -> "ReplayBuffer":
        """Insert a [B, ...] batch of transitions at the ring pointer."""
        cap = self.obs.shape[0]
        b = obs.shape[0]
        idx = (self.ptr + jnp.arange(b)) % cap
        return self.replace(
            obs=self.obs.at[idx].set(obs),
            action=self.action.at[idx].set(action),
            reward=self.reward.at[idx].set(reward),
            next_obs=self.next_obs.at[idx].set(next_obs),
            done=self.done.at[idx].set(done),
            ptr=(self.ptr + b) % cap,
            size=jnp.minimum(self.size + b, cap),
        )

    def sample(self, key, batch_size: int):
        idx = jax.random.randint(key, (batch_size,), 0, jnp.maximum(self.size, 1))
        return {
            "obs": self.obs[idx],
            "action": self.action[idx],
            "reward": self.reward[idx],
            "next_obs": self.next_obs[idx],
            "done": self.done[idx],
        }


@struct.dataclass
class MADDPGState:
    actor_params: dict  # stacked [N, ...]
    critic_params: dict  # stacked [N, ...]
    target_actor_params: dict
    target_critic_params: dict
    actor_opt: optax.OptState
    critic_opt: optax.OptState
    noise: Array
    epsilon: Array
    env_steps: Array
    grad_updates: Array
    ou_state: Array  # [B, N, da] OU process state (zeros when unused)


class MADDPG:
    def __init__(
        self, env: FormationEnv, cfg: MADDPGConfig = MADDPGConfig(), num_envs: int = 32
    ):
        self.env = env
        self.cfg = cfg
        self.num_envs = num_envs
        self.n_agents = env.num_agents
        self.obs_dim = env.scenario.obs_dim
        self.act_dim = env.act_dim
        # discrete envs take one-hot actions: logits actor + gumbel-softmax
        # through the critic, the reference v2 discrete path
        # (``maddpg-v2/algorithms/maddpg.py:166-180``, ``utils/misc.py:49-80``)
        self.discrete = bool(env.discrete_action and not env.discrete_action_input)
        if self.discrete:
            self.actor = LogitsActor(self.act_dim, cfg.hidden)
        else:
            self.actor = DeterministicActor(self.act_dim, cfg.high_action, cfg.hidden)
        self.critic = CentralizedQCritic(cfg.high_action, cfg.hidden)
        self.actor_tx = optax.adam(cfg.lr_actor)
        self.critic_tx = optax.adam(cfg.lr_critic)

    # -- param stacking over the agent axis ---------------------------------
    def _init_stacked(self, key):
        n = self.n_agents
        ka, kc = jax.random.split(key)
        m = n if self.cfg.centralized else 1
        obs0 = jnp.zeros((1, self.obs_dim))
        oall0 = jnp.zeros((1, self.obs_dim * m))
        uall0 = jnp.zeros((1, self.act_dim * m))
        actor_params = jax.vmap(lambda k: self.actor.init(k, obs0))(
            jax.random.split(ka, n)
        )
        critic_params = jax.vmap(lambda k: self.critic.init(k, oall0, uall0))(
            jax.random.split(kc, n)
        )
        return actor_params, critic_params

    def _actor_all(self, params, obs):
        """Stacked per-agent actor apply: obs [..., N, do] → [..., N, da]."""
        return jax.vmap(self.actor.apply, in_axes=(0, -2), out_axes=-2)(params, obs)

    def init(self, key: Array):
        k_net, k_env = jax.random.split(key)

        @jax.jit
        def _init(k):
            actor_params, critic_params = self._init_stacked(k)
            copy = lambda t: jax.tree.map(lambda x: x + 0, t)
            return MADDPGState(
                actor_params=actor_params,
                critic_params=critic_params,
                # distinct buffers: train_step donates the whole state, and
                # donated args must not alias
                target_actor_params=copy(actor_params),
                target_critic_params=copy(critic_params),
                actor_opt=self.actor_tx.init(actor_params),
                critic_opt=self.critic_tx.init(critic_params),
                noise=jnp.asarray(self.cfg.noise_rate, jnp.float32),
                epsilon=jnp.asarray(self.cfg.epsilon, jnp.float32),
                env_steps=jnp.zeros((), jnp.int32),
                grad_updates=jnp.zeros((), jnp.int32),
                ou_state=jnp.full(
                    (self.num_envs, self.n_agents, self.act_dim),
                    self.cfg.ou_mu,
                    jnp.float32,
                ),
            )

        ts = _init(k_net)
        if self.cfg.use_per:
            from .per import PrioritizedReplayBuffer

            buffer = PrioritizedReplayBuffer.create(
                self.cfg.buffer_size, self.n_agents, self.obs_dim, self.act_dim
            )
        else:
            buffer = ReplayBuffer.create(
                self.cfg.buffer_size, self.n_agents, self.obs_dim, self.act_dim
            )
        # jit: eager vmapped reset is pathological on remote backends
        env_state, obs = jax.jit(jax.vmap(self.env.reset))(
            jax.random.split(k_env, self.num_envs)
        )
        return ts, buffer, env_state, obs

    # -- exploration (reference agent.py:13-23; v2 utils/noise.py) ----------
    def explore_actions(self, ts: MADDPGState, obs: Array, key):
        """ε-greedy uniform vs actor + noise (Gaussian, or OU when
        ``cfg.ou_noise``), clipped to ±high.  Returns ``(actions, ts)`` with
        the advanced OU state."""
        cfg = self.cfg
        k_eps, k_uni, k_noise = jax.random.split(key, 3)
        B = obs.shape[0]
        pi = self._actor_all(ts.actor_params, obs)
        if self.discrete:
            # v2 explores discrete actions by SAMPLING a hard gumbel-softmax
            # of the logits (``maddpg-v2/utils/agents.py:55-62``; its
            # onehot_from_logits eps arg is never used) — equivalent to a
            # categorical draw from softmax(logits), no ε-greedy mixing
            g = jax.random.gumbel(k_noise, pi.shape, pi.dtype)
            idx = jnp.argmax(pi + g, axis=-1)
            return jax.nn.one_hot(idx, self.act_dim, dtype=pi.dtype), ts
        if cfg.ou_noise:
            x = ts.ou_state
            x = x + cfg.ou_theta * (cfg.ou_mu - x) + cfg.ou_sigma * (
                jax.random.normal(k_noise, x.shape, x.dtype)
            )
            ts = ts.replace(ou_state=x)
            noise_term = ts.noise * x
        else:
            noise_term = ts.noise * cfg.high_action * jax.random.normal(
                k_noise, pi.shape
            )
        noisy = jnp.clip(pi + noise_term, -cfg.high_action, cfg.high_action)
        uniform = jax.random.uniform(
            k_uni, pi.shape, pi.dtype, -cfg.high_action, cfg.high_action
        )
        take_uniform = (
            jax.random.uniform(k_eps, (B, self.n_agents, 1)) < ts.epsilon
        )
        return jnp.where(take_uniform, uniform, noisy), ts

    # -- losses -------------------------------------------------------------
    def _losses(self, actor_params, critic_params, ts, batch, weights=None):
        """Joint per-agent losses, all agents at once.

        critic_i: MSE to r_i + γ Q'_i(o', a'_targets);
        actor_i: −Q_i(o, u with own action re-sampled) (``maddpg.py:88-91``).
        """
        cfg = self.cfg
        M = batch["obs"].shape[0]
        o_all = batch["obs"].reshape(M, -1)
        u_all_b = batch["action"]
        on_all = batch["next_obs"].reshape(M, -1)
        u_next = self._target_actions(ts, batch)
        un_all = u_next.reshape(M, -1)
        nonterm = (
            (1.0 - batch["done"].astype(jnp.float32)) if cfg.mask_done else 1.0
        )

        cen = cfg.centralized

        def per_agent(i, aparams_i, cparams_i, tcparams_i):
            o_in = o_all if cen else batch["obs"][:, i]
            on_in = on_all if cen else batch["next_obs"][:, i]
            u_in = u_all_b.reshape(M, -1) if cen else u_all_b[:, i]
            un_in = un_all if cen else u_next[:, i]
            q_next = self._q_target(tcparams_i, on_in, un_in, ts)
            target = batch["reward"][:, i] + cfg.gamma * q_next * nonterm
            sq_err, td_abs = self._critic_bellman_err(
                cparams_i, o_in, u_in, jax.lax.stop_gradient(target)
            )
            w = jnp.ones_like(sq_err) if weights is None else weights
            critic_loss = jnp.mean(w * sq_err)
            # actor: substitute own action (others fixed from the batch)
            a_i = self.actor.apply(aparams_i, batch["obs"][:, i])
            if self.discrete:
                # straight-through gumbel sample so ∂Q/∂logits flows
                # (v2 ``algorithms/maddpg.py:172-174``); v2 also regularizes
                # the raw net output, ``:184``
                logits_i = a_i
                a_i = gumbel_softmax_st(
                    jax.random.fold_in(batch["noise_key"], i), logits_i
                )
                reg = 1e-3 * jnp.mean(logits_i**2)
            else:
                reg = 0.0
            u_sub = (
                u_all_b.at[:, i].set(a_i).reshape(M, -1) if cen else a_i
            )
            actor_loss = reg - jnp.mean(
                self._q_policy(jax.lax.stop_gradient(cparams_i), o_in, u_sub)
            )
            return critic_loss, actor_loss, td_abs

        idx = jnp.arange(self.n_agents)
        critic_losses, actor_losses, td_abs = jax.vmap(
            per_agent, in_axes=(0, 0, 0, 0)
        )(idx, actor_params, critic_params, ts.target_critic_params)
        return critic_losses.sum() + actor_losses.sum(), {
            "critic_loss": critic_losses.mean(),
            "actor_loss": actor_losses.mean(),
            # per-sample |TD| averaged over agents → PER priority signal
            "td_abs": jax.lax.stop_gradient(td_abs.mean(axis=0)),
        }

    # Hooks specialized by MATD3 (twin critics + target smoothing).
    def _target_actions(self, ts, batch):
        out = self._actor_all(ts.target_actor_params, batch["next_obs"])
        # discrete: greedy one-hot from target logits (v2 ``maddpg.py:150-156``)
        return onehot_from_logits(out) if self.discrete else out

    def _q_target(self, tcparams_i, on_in, un_in, ts):
        return self.critic.apply(tcparams_i, on_in, un_in)

    def _critic_bellman_err(self, cparams_i, o_in, u_in, target):
        """Per-sample squared Bellman error and |TD| (for PER priorities)."""
        q = self.critic.apply(cparams_i, o_in, u_in)
        return (target - q) ** 2, jnp.abs(target - q)

    def _q_policy(self, cparams_i, o_in, u_sub):
        return self.critic.apply(cparams_i, o_in, u_sub)

    def _update_once(self, ts: MADDPGState, batch, weights=None):
        cfg = self.cfg

        # one combined gradient: the cross terms are stop_gradient'ed inside
        # _losses, so grads match the two-pass version at half the cost
        def loss_fn(params):
            return self._losses(params["actor"], params["critic"], ts, batch, weights)

        grads, aux = jax.grad(loss_fn, has_aux=True)(
            {"actor": ts.actor_params, "critic": ts.critic_params}
        )
        a_grads, c_grads = grads["actor"], grads["critic"]
        a_updates, actor_opt = self.actor_tx.update(a_grads, ts.actor_opt)
        c_updates, critic_opt = self.critic_tx.update(c_grads, ts.critic_opt)
        actor_params = optax.apply_updates(ts.actor_params, a_updates)
        critic_params = optax.apply_updates(ts.critic_params, c_updates)
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

    # -- public api ---------------------------------------------------------
    @partial(jax.jit, static_argnums=0, donate_argnums=(1, 2, 3, 4))
    def train_step(self, ts: MADDPGState, buffer: ReplayBuffer, env_state, obs, key):
        """Collect ``steps_per_iter`` vectorized env steps into the buffer,
        then run ``updates_per_iter`` gradient updates.  Fully jitted."""
        cfg = self.cfg

        def env_step(carry, k):
            ts, buffer, env_state, obs = carry
            k_act, _ = jax.random.split(k)
            actions, ts = self.explore_actions(ts, obs, k_act)
            env_state, out = jax.vmap(self.env.step)(env_state, actions)
            if cfg.ou_noise:
                # reset the OU process at episode boundaries (v2 resets
                # exploration per episode, ``maddpg-v2/main.py:57-59``)
                ts = ts.replace(
                    ou_state=jnp.where(
                        out.done[:, :1, None],
                        jnp.asarray(cfg.ou_mu, ts.ou_state.dtype),
                        ts.ou_state,
                    )
                )
            # true pre-reset obs for terminal transitions (auto-reset envs
            # return the NEXT episode's obs in out.obs)
            next_obs = out.info.get("terminal_obs", out.obs)
            buffer = buffer.insert(
                obs, actions, out.reward, next_obs, out.done[:, 0]
            )
            decay = cfg.explore_decay * self.num_envs
            ts = ts.replace(
                noise=jnp.maximum(cfg.explore_min, ts.noise - decay),
                epsilon=jnp.maximum(cfg.explore_min, ts.epsilon - decay),
                env_steps=ts.env_steps + self.num_envs,
            )
            return (ts, buffer, env_state, obs := out.obs), (
                out.reward.mean(),
                benchmark_means(out.info),
            )

        (ts, buffer, env_state, obs), (step_rew, bench) = jax.lax.scan(
            env_step,
            (ts, buffer, env_state, obs),
            jax.random.split(key, cfg.steps_per_iter),
        )

        def upd(carry, k):
            ts, buffer = carry
            if cfg.use_per:
                from .per import beta_schedule

                beta = beta_schedule(ts.env_steps, cfg.per_beta0, cfg.per_beta_anneal)
                batch, idx, w = buffer.sample_prioritized(
                    k, cfg.batch_size, cfg.per_alpha, beta
                )
                batch["noise_key"] = jax.random.fold_in(k, 7)
                ts, aux = self._update_once(ts, batch, w)
                buffer = buffer.update_priorities(idx, aux["td_abs"])
            else:
                batch = buffer.sample(k, cfg.batch_size)
                batch["noise_key"] = jax.random.fold_in(k, 7)
                ts, aux = self._update_once(ts, batch)
            aux = {k2: v for k2, v in aux.items() if k2 != "td_abs"}
            return (ts, buffer), aux

        can_train = buffer.size >= cfg.batch_size
        keys = jax.random.split(jax.random.fold_in(key, 1), cfg.updates_per_iter)

        def do_train(args):
            (ts, buffer), aux = jax.lax.scan(upd, args, keys)
            return ts, buffer, aux

        def skip(args):
            ts, buffer = args
            zero = {"critic_loss": jnp.zeros(cfg.updates_per_iter),
                    "actor_loss": jnp.zeros(cfg.updates_per_iter)}
            return ts, buffer, zero

        ts, buffer, aux = jax.lax.cond(can_train, do_train, skip, (ts, buffer))
        metrics = {k: v.mean() for k, v in aux.items()}
        metrics["mean_step_reward"] = step_rew.mean()
        metrics["buffer_size"] = buffer.size
        metrics.update({k: v.mean() for k, v in bench.items()})
        return ts, buffer, env_state, obs, metrics

    def eval_actions(self, ts: MADDPGState, obs: Array) -> Array:
        out = self._actor_all(ts.actor_params, obs)
        return onehot_from_logits(out) if self.discrete else out
