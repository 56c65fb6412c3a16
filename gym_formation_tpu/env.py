"""Functional multi-agent environment API.

A functional replacement for the reference ``MultiAgentEnv``
(``formation_gym/environment.py:11-236``).  Instead of a
stateful object mutated per step, :class:`FormationEnv` exposes pure
``reset(key) -> (state, obs)`` and ``step(state, actions) -> (state,
StepOut)`` over one environment; :class:`VecFormationEnv` jits + vmaps them
over an env batch (optionally sharded over a device mesh).  This collapses the
reference's SubprocVecEnv pipe protocol (``train/maddpg-v4/wrapper.py``) into
a single compiled program: episode bookkeeping, time-limit dones
(``environment.py:172-178``), shared-reward broadcast
(``environment.py:135-138``) and worker-side auto-reset
(``train/maddpg-v4/wrapper.py:140-145``) all run inside jit.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from . import spaces
from .core.physics import world_step
from .core.types import EnvState, StepOut
from .envs.scenario import Scenario

Array = jnp.ndarray

# Discrete action index → movement direction, the ``discrete_action_input``
# decoding of ``environment.py:194-204`` (0: noop, 1:-x, 2:+x, 3:-y, 4:+y).
_DISCRETE_MOVES = np.array(
    [[0.0, 0.0], [-1.0, 0.0], [1.0, 0.0], [0.0, -1.0], [0.0, 1.0]]
)

# The benchmark_data quartet (``envs/formation_hd_env.py:97-117``).
BENCHMARK_KEYS = ("reward", "collisions", "min_dists", "occupied_landmarks")


def benchmark_means(info: dict) -> dict:
    """Scalar means of the benchmark quartet present in a step's ``info``
    (populated when the env was built with ``benchmark=True``) under
    ``bench_*`` keys — the training-time equivalent of the reference's
    ``make_env(benchmark=True)`` info_callback instrumentation
    (``formation_gym/__init__.py:13-14``).  Empty dict otherwise, so collect
    loops can thread it unconditionally."""
    return {f"bench_{k}": jnp.mean(info[k]) for k in BENCHMARK_KEYS if k in info}


class FormationEnv:
    """One formation-control environment as a pair of pure functions.

    Args:
      scenario: scenario instance (see :mod:`gym_formation_tpu.envs`).
      benchmark: include the benchmark_data quartet in ``info`` (the
        ``make_env(benchmark=True)`` path, ``__init__.py:13-14``).
      auto_reset: re-draw a fresh episode inside ``step`` when the episode
        ends (vec-env worker behavior, inside jit).
      discrete_action: 5-way one-hot action decoding instead of continuous
        (``environment.py:64-65,206-210``).
      discrete_action_input: actions are integer indices (``:194-204``).
      force_discrete_action: continuous actions are snapped to a one-hot
        over the first ``dim_p`` entries before scaling — the reference's
        ``force_discrete_action`` attribute (``environment.py:212-215``;
        driven by ``world.discrete_action``, which no shipped scenario
        sets — kept for surface parity).
    """

    def __init__(
        self,
        scenario: Scenario,
        benchmark: bool = False,
        auto_reset: bool = True,
        discrete_action: bool = False,
        discrete_action_input: bool = False,
        force_discrete_action: bool = False,
    ):
        self.scenario = scenario
        self.cfg = scenario.cfg
        self.benchmark = benchmark
        self.auto_reset = auto_reset
        self.discrete_action = discrete_action
        self.discrete_action_input = discrete_action_input
        self.force_discrete_action = force_discrete_action
        cfg = self.cfg
        n = cfg.n_agents
        self.num_agents = n
        self.world_length = cfg.world_length
        self.shared_reward = cfg.collaborative
        # sensitivity = accel if set else 5.0, applied to the control before
        # the physics' own mass*(accel or 1) factor (``environment.py:218-221``
        # — the reference double-applies accel; scenarios here never set it).
        # Explicit in WorldCfg; the accel-derived fallback only serves
        # hand-built configs predating the field.
        if cfg.sensitivity is not None:
            self._sensitivity = np.asarray(cfg.sensitivity)
        else:
            accel = cfg.act_coef / cfg.mass[:n]
            self._sensitivity = np.where(np.isclose(accel, 1.0), 5.0, accel)
        self._all_silent = bool(np.all(cfg.silent))

        # Spaces (``environment.py:56-96``).
        self.action_space = []
        self.observation_space = []
        for i in range(n):
            if discrete_action:
                u_space = spaces.Discrete(cfg.dim_p * 2 + 1)
            else:
                u_space = spaces.Box(-cfg.u_range, cfg.u_range, (cfg.dim_p,))
            if cfg.silent[i]:
                self.action_space.append(u_space)
            else:
                c_space = (
                    spaces.Discrete(cfg.dim_c)
                    if discrete_action
                    else spaces.Box(0.0, 1.0, (cfg.dim_c,))
                )
                self.action_space.append(spaces.Tuple((u_space, c_space)))
            self.observation_space.append(
                spaces.Box(-np.inf, np.inf, (scenario.obs_dim,))
            )
        share_dim = scenario.obs_dim * n
        self.share_observation_space = [
            spaces.Box(-np.inf, np.inf, (share_dim,)) for _ in range(n)
        ]

    # -- action layout ------------------------------------------------------
    @property
    def act_dim(self) -> int:
        """Flat per-agent action width fed to :meth:`step`."""
        if self.discrete_action_input:
            return 1
        move = 5 if self.discrete_action else self.cfg.dim_p
        comm = 0 if self._all_silent else self.cfg.dim_c
        return move + comm

    def _decode_actions(self, actions: Array) -> Tuple[Array, Optional[Array]]:
        """[N, act_dim] → physical control u [N, dim_p] (sensitivity-scaled)
        and comm action (or None).  ``environment.py:187-236``."""
        cfg = self.cfg
        if self.discrete_action_input:
            idx = actions.reshape(-1).astype(jnp.int32)
            u = jnp.asarray(_DISCRETE_MOVES, jnp.float32)[idx]
            comm = None
        elif self.discrete_action:
            u = jnp.stack(
                [actions[:, 1] - actions[:, 2], actions[:, 3] - actions[:, 4]], -1
            )
            comm = None if self._all_silent else actions[:, 5 : 5 + cfg.dim_c]
        else:
            u = actions[:, : cfg.dim_p]
            if self.force_discrete_action:
                # snap to a one-hot over dim_p (``environment.py:212-215``:
                # argmax, zero the vector, set 1.0 at the argmax)
                idx = jnp.argmax(u, axis=-1)
                u = jax.nn.one_hot(idx, cfg.dim_p, dtype=u.dtype)
            comm = (
                None
                if self._all_silent
                else actions[:, cfg.dim_p : cfg.dim_p + cfg.dim_c]
            )
        u = u * jnp.asarray(self._sensitivity, u.dtype)[:, None]
        return u, comm

    # -- pure env functions -------------------------------------------------
    def reset(self, key: Array) -> Tuple[EnvState, Array]:
        """Fresh episode: scenario reset + initial observations
        (``environment.py:144-156``)."""
        state = self.scenario.pre_obs(self.scenario.reset(key))
        return state, self.scenario.observe(state)

    def step(self, state: EnvState, actions: Array) -> Tuple[EnvState, StepOut]:
        """Advance one step.  ``actions``: [n_agents, act_dim]."""
        scen, cfg = self.scenario, self.cfg
        u, comm = self._decode_actions(actions)
        if scen.scripted_mask is not None:
            # scripted agents override the policy control (core.py:210-211)
            mask = jnp.asarray(scen.scripted_mask)[:, None]
            u = jnp.where(mask, scen.scripted_actions(state).astype(u.dtype), u)
        key, k_noise, k_reset = jax.random.split(state.key, 3)
        pos, vel = world_step(
            state.pos, state.vel, u.astype(state.pos.dtype), cfg,
            k_noise if cfg.has_noise() else None,
        )
        # Comm state update (``core.py:279-286``): silent agents emit zeros.
        if self._all_silent or comm is None:
            c = jnp.zeros_like(state.c)
        else:
            silent = jnp.asarray(cfg.silent)[:, None]
            c = jnp.where(silent, 0.0, comm.astype(state.c.dtype))
        state = state.replace(pos=pos, vel=vel, c=c, t=state.t + 1, key=key)

        state = scen.pre_obs(state)
        obs = scen.observe(state)
        indiv = scen.reward(state)
        if self.shared_reward:
            reward = jnp.broadcast_to(jnp.sum(indiv), indiv.shape)
        else:
            reward = indiv
        done_flag = state.t >= self.world_length
        done = jnp.broadcast_to(done_flag, (cfg.n_agents,))
        info = {"individual_reward": indiv}
        if self.benchmark:
            info.update(scen.benchmark(state))
        state = scen.post_step(state)

        if self.auto_reset:
            # keep the true pre-reset observation available for off-policy
            # bootstrapping (unused consumers are DCE'd by XLA)
            info["terminal_obs"] = obs
            reset_state, reset_obs = self.reset(k_reset)
            state = jax.tree.map(
                lambda a, b: jnp.where(
                    jnp.reshape(done_flag, (1,) * a.ndim), a, b
                ),
                reset_state,
                state,
            )
            obs = jnp.where(done_flag, reset_obs, obs)
        return state, StepOut(obs=obs, reward=reward, done=done, info=info)

    def sample_actions(self, key: Array) -> Array:
        """Uniform random joint action [n_agents, act_dim] (the ``test.py -r``
        driver path)."""
        if self.discrete_action_input:
            return jax.random.randint(key, (self.num_agents, 1), 0, 5)
        return jax.random.uniform(
            key,
            (self.num_agents, self.act_dim),
            jnp.float32,
            -self.cfg.u_range,
            self.cfg.u_range,
        )


class VecFormationEnv:
    """A batch of identical envs stepping in lockstep under one jit.

    The single-program replacement for ``SubprocVecEnv``/``DummyVecEnv``
    (``train/maddpg-v2/utils/env_wrappers.py:9-129``): the batch is a leading
    axis of the state pytree, optionally sharded over a mesh axis so the
    fleet spans devices and hosts with zero host involvement.
    """

    def __init__(self, env: FormationEnv, num_envs: int, sharding=None):
        self.env = env
        self.num_envs = num_envs
        self.sharding = sharding
        donate = dict(donate_argnums=(0,))
        self._reset = jax.jit(jax.vmap(env.reset), out_shardings=sharding)
        self._step = jax.jit(
            jax.vmap(env.step), out_shardings=sharding, **donate
        )

        def _choose(state, obs, keys, choose):
            fresh_state, fresh_obs = jax.vmap(env.reset)(keys)
            sel = lambda a, b: jnp.where(
                choose.reshape((-1,) + (1,) * (a.ndim - 1)), a, b
            )
            return jax.tree.map(sel, fresh_state, state), sel(fresh_obs, obs)

        # no donation: callers routinely keep the pre-reset state/obs around
        # (e.g. to log terminal stats), and this is not a hot path
        self._reset_choose = jax.jit(_choose, out_shardings=sharding)

    def reset(self, key: Array):
        keys = jax.random.split(key, self.num_envs)
        return self._reset(keys)

    def reset_choose(self, state, obs, key: Array, choose):
        """Selectively re-draw fresh episodes for envs where ``choose`` is
        True, leaving the rest untouched — the Choose* vec-env capability
        (``train/maddpg-v4/wrapper.py:225-486`` ``reset_choose``), as one
        jitted select instead of per-worker pipe commands.

        Args:
          state, obs: current batched env state and observations.
          key: PRNG key (split per env; only chosen envs consume theirs).
          choose: [num_envs] bool mask.
        Returns ``(state, obs)`` with chosen envs freshly reset."""
        keys = jax.random.split(key, self.num_envs)
        return self._reset_choose(state, obs, keys, jnp.asarray(choose))

    def step(self, state, actions: Array):
        """state, actions [B, N, act_dim] → (state, StepOut batched)."""
        return self._step(state, actions)

    def sample_actions(self, key: Array) -> Array:
        keys = jax.random.split(key, self.num_envs)
        return jax.vmap(self.env.sample_actions)(keys)


def rollout(
    env: FormationEnv,
    policy_fn,
    state: EnvState,
    obs: Array,
    key: Array,
    length: int,
):
    """Scan ``length`` env steps with ``policy_fn(obs, key) -> actions``.

    Single-env version; vmap for a batch.  Returns ``(state, obs)`` carry and
    stacked :class:`StepOut`.  The entire loop compiles to one XLA scan — the
    replacement for the trainer-side Python step loops
    (``train/maddpg-v1/runner.py:31-54``).
    """

    def body(carry, _):
        st, ob, k = carry
        k, k_act = jax.random.split(k)
        actions = policy_fn(ob, k_act)
        st, out = env.step(st, actions)
        return (st, out.obs, k), out

    (state, obs, _), outs = jax.lax.scan(
        body, (state, obs, key), None, length=length
    )
    return (state, obs), outs


def rollout_stateonly(
    env: FormationEnv,
    policy_fn,
    state: EnvState,
    key: Array,
    length: int,
):
    """Memory-lean rollout: carries ONLY the env state and recomputes the
    observation from it each step instead of threading obs through the scan
    carry.  At large scale the obs carry dominates memory (e.g. N=243 ×
    B=8192: three 11.6 GB [B, N, 6N] buffers live at once under
    :func:`rollout`); recomputing keeps a single in-flight obs.  Returns the
    final state and the per-step rewards [T, n_agents]."""

    def body(carry, _):
        st, k = carry
        obs = env.scenario.observe(env.scenario.pre_obs(st))
        k, k_act = jax.random.split(k)
        actions = policy_fn(obs, k_act)
        st, out = env.step(st, actions)
        return (st, k), out.reward

    (state, _), rewards = jax.lax.scan(body, (state, key), None, length=length)
    return state, rewards


def rollout_statepolicy(
    env: FormationEnv,
    state_policy_fn,
    state: EnvState,
    key: Array,
    length: int,
):
    """Rollout for policies that consume the ``EnvState`` directly
    (``state_policy_fn(state, key) -> actions``), e.g.
    :func:`~gym_formation_tpu.models.bfs.bfs_actions_from_state` closures.

    No observation tensor is ever materialized: the [N, 6N] obs is O(N²)
    per agent and dominates memory traffic at large N, while scripted and
    hierarchical controllers only need O(N) state quantities.  Actions (and
    hence trajectories/rewards) are identical to driving :func:`rollout`
    with the equivalent obs-consuming policy.  Returns the final state and
    per-step rewards [T, n_agents]."""

    def body(carry, _):
        st, k = carry
        k, k_act = jax.random.split(k)
        actions = state_policy_fn(env.scenario.pre_obs(st), k_act)
        st, out = env.step(st, actions)
        return (st, k), out.reward

    (state, _), rewards = jax.lax.scan(body, (state, key), None, length=length)
    return state, rewards


def rollout_statepolicy_rewardsum(
    env: FormationEnv,
    state_policy_fn,
    state: EnvState,
    key: Array,
    length: int,
):
    """:func:`rollout_statepolicy` but accumulating the reward *sum* in the
    scan carry instead of stacking per-step rewards.  The stacked [T, N]
    output is a scan output XLA must materialize — at the large-batch bench
    configs it dominates memory (N=243, B=8192, T=256: an 8.2 GB reward
    tensor).  Returns (state, scalar reward sum).
    """

    def body(carry, _):
        st, k, acc = carry
        k, k_act = jax.random.split(k)
        actions = state_policy_fn(env.scenario.pre_obs(st), k_act)
        st, out = env.step(st, actions)
        return (st, k, acc + out.reward.sum()), None

    (state, _, rsum), _ = jax.lax.scan(
        body, (state, key, jnp.zeros((), state.pos.dtype)), None, length=length
    )
    return state, rsum


def make_receptor_locations(receptor_type: str = "polar") -> np.ndarray:
    """Receptor-field offsets in the agent's local frame — the reference's
    (unused) observation helper ``environment.py:396-414``, kept for surface
    parity.  ``polar``: 8 angles × 3 radii in [0.1, 1.0] plus the origin
    (25 points); ``grid``: a 5×5 lattice over [-1, 1]².  Returns [K, 2]."""
    if receptor_type == "polar":
        angles = np.linspace(-np.pi, np.pi, 8, endpoint=False)
        radii = np.linspace(0.05 * 2.0, 1.0, 3)
        pts = [
            r * np.array([np.cos(a), np.sin(a)]) for a in angles for r in radii
        ]
        pts.append(np.zeros(2))
    elif receptor_type == "grid":
        xs = np.linspace(-1.0, 1.0, 5)
        pts = [np.array([x, y]) for x in xs for y in xs]
    else:
        raise ValueError(f"unknown receptor_type: {receptor_type!r}")
    return np.stack(pts)
