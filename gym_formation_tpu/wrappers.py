"""Imperative (stateful) adapters over the functional core.

The execution model is functional — explicit ``EnvState``,
jitted ``reset``/``step``, ``vmap`` over the env batch.  These wrappers
re-expose the reference's *user-facing* imperative contracts on top of it
for drop-in migration and for host-side trainers:

* :class:`GymMultiAgentEnv` — the reference ``MultiAgentEnv`` step/reset
  contract (``environment.py:113-156``): ``reset() -> obs_n`` list,
  ``step(action_n) -> (obs_n, reward_n, done_n, info_n)`` with the nested
  ``[[r]]`` per-agent reward quirk (``environment.py:128,138``; SURVEY
  §8.10 — trainers index ``r[agent][0]``) and per-agent
  ``{'individual_reward': r}`` info dicts (``environment.py:130-134``).
* :class:`DictAgentEnv` — the maddpg-v3 RLlib-style adapter
  (``train/maddpg-v3/env/wrapper.py:15-84``): dict-keyed obs/reward/done
  per agent id, the required ``done["__all__"]``, and the v3 per-agent
  ``{"done": d}`` info workaround (``wrapper.py:72-75``).

Both keep every array op inside jit (one compiled ``step`` / ``reset``)
so each call is one device dispatch, not hundreds; the per-step
host↔device hop is inherent to the imperative contract — batch throughput
lives in :class:`~gym_formation_tpu.env.VecFormationEnv` + ``rollout``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .env import FormationEnv


class GymMultiAgentEnv:
    """Stateful list-in/list-out env mirroring the reference ``MultiAgentEnv``.

    Args:
      env: a :class:`FormationEnv` to wrap, or ``None`` to build one from
        ``scenario_name`` and ``make_env`` kwargs.  Auto-reset is disabled —
        like the reference env, episode restarts are the caller's job
        (vec-env workers did it in the reference; here
        :class:`VecFormationEnv` does, inside jit).
      scenario_name / benchmark / num_agents / kwargs: forwarded to
        :func:`gym_formation_tpu.make_env`.
    """

    def __init__(
        self,
        scenario_name: str = "basic_formation_env",
        benchmark: bool = False,
        num_agents: int = 3,
        env: Optional[FormationEnv] = None,
        **kwargs: Any,
    ):
        if env is None:
            from . import make_env

            env = make_env(
                scenario_name,
                benchmark=benchmark,
                num_agents=num_agents,
                auto_reset=False,
                **kwargs,
            )
        elif env.auto_reset:
            # The imperative contract returns the TERMINAL obs at
            # t == world_length and leaves restarts to the caller
            # (environment.py:144-156); rebuild without in-jit auto-reset.
            env = FormationEnv(
                env.scenario,
                benchmark=env.benchmark,
                auto_reset=False,
                discrete_action=env.discrete_action,
                discrete_action_input=env.discrete_action_input,
                force_discrete_action=env.force_discrete_action,
            )
        self._env = env
        self.num_agents = env.num_agents
        self.n = env.num_agents  # legacy-MPE alias (inbox/environment.py:29)
        self.world_length = env.world_length
        self.action_space = env.action_space
        self.observation_space = env.observation_space
        self.share_observation_space = env.share_observation_space
        self._reset_fn = jax.jit(env.reset)
        self._step_fn = jax.jit(env.step)
        self._state = None
        self.seed()

    # -- reference API --------------------------------------------------
    def seed(self, seed: Optional[int] = None) -> None:
        """Reseed the episode RNG.  Default seed 1 like the reference
        (``environment.py:106-110``), but per-env — never global."""
        self._key = jax.random.PRNGKey(1 if seed is None else seed)

    def reset(self) -> List[np.ndarray]:
        """Fresh episode → per-agent observation list
        (``environment.py:144-156``)."""
        self._key, k = jax.random.split(self._key)
        self._state, obs = self._reset_fn(k)
        return list(np.asarray(obs))

    def step(
        self, action_n: Sequence[np.ndarray]
    ) -> Tuple[List[np.ndarray], List[List[float]], List[bool], List[dict]]:
        """One step: ``(obs_n, reward_n, done_n, info_n)`` with the
        reference's nesting (``environment.py:113-142``)."""
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        acts = jnp.asarray(
            np.stack([np.asarray(a, np.float32).reshape(-1) for a in action_n])
        )
        self._state, out = self._step_fn(self._state, acts)
        # one device->host transfer for the whole StepOut (the per-step hop
        # is inherent to the imperative contract; don't pay it per field)
        obs, reward, done, info = jax.device_get(
            (out.obs, out.reward, out.done, out.info)
        )
        obs_n = list(obs)
        reward_n = [[float(r)] for r in reward]
        done_n = [bool(d) for d in done]
        info = {k: np.asarray(v) for k, v in info.items()}
        info_n = [
            {k: (v[i] if v.ndim else v) for k, v in info.items()}
            for i in range(self.num_agents)
        ]
        return obs_n, reward_n, done_n, info_n

    def render(self, mode: str = "rgb_array", size: int = 350) -> np.ndarray:
        """Headless frame of the current state (reference
        ``environment.py:243-393`` camera/colors via the native renderer)."""
        from .render import render_state

        if self._state is None:
            raise RuntimeError("call reset() before render()")
        return render_state(self._env.scenario, self._state, size=size)

    @property
    def state(self):
        """The underlying functional :class:`EnvState` (device pytree)."""
        return self._state


class DictAgentEnv:
    """RLlib-style dict adapter — rebuild of the maddpg-v3 ``FormationEnv``
    wrapper (``train/maddpg-v3/env/wrapper.py:15-84``)."""

    def __init__(self, **mpe_args: Any):
        self._env = GymMultiAgentEnv(**mpe_args)
        self.num_agents = self._env.num_agents
        self.agent_ids = list(range(self.num_agents))
        self.observation_space_dict = self._make_dict(self._env.observation_space)
        self.action_space_dict = self._make_dict(self._env.action_space)

    def seed(self, seed: Optional[int] = None) -> None:
        self._env.seed(seed)

    def reset(self) -> Dict[int, np.ndarray]:
        return self._make_dict(self._env.reset())

    def step(self, action_dict: Dict[int, np.ndarray]):
        """dict-in/dict-out step with ``done["__all__"]``
        (``wrapper.py:47-77``); per-agent termination is surfaced through
        ``info[i]["done"]`` exactly like the v3 workaround (``:72-75``)."""
        actions = [action_dict[i] for i in self.agent_ids]
        obs_n, rew_n, done_n, _ = self._env.step(actions)
        obs_dict = self._make_dict(obs_n)
        # the reference passes the nested [r] lists straight through
        # (wrapper.py:66-70 over environment.py:128,138) — keep the quirk
        rew_dict = self._make_dict(rew_n)
        done_dict = self._make_dict(done_n)
        done_dict["__all__"] = all(done_n)
        info_dict = self._make_dict([{"done": d} for d in done_n])
        return obs_dict, rew_dict, done_dict, info_dict

    def render(self, mode: str = "rgb_array") -> np.ndarray:
        return self._env.render(mode=mode)

    def _make_dict(self, values: Sequence) -> Dict[int, Any]:
        return dict(zip(self.agent_ids, values))
