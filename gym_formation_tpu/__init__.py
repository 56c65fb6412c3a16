"""gym_formation_tpu — multi-agent formation-control framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of ``jc-bao/gym-formation``:
the MPE point-mass world, five
formation scenarios, scripted + hierarchical policies, and MAPPO/MADDPG
learners — all as pure jitted functions vmapped over thousands of lockstep
environments and sharded over a ``jax.sharding.Mesh``.

Facade mirrors ``formation_gym`` (the reference's ``formation_gym/__init__.py``):
``make_env``, ``ezpolicy``, ``get_action_BFS``, plus the vectorized
entry points.
"""

from . import spaces
from .core import EnvState, StepOut, WorldCfg
from .env import (
    FormationEnv,
    VecFormationEnv,
    rollout,
    rollout_statepolicy,
    rollout_statepolicy_rewardsum,
    rollout_stateonly,
)
from .envs import SCENARIOS, generate_shape, make_scenario, register
from .models import (
    bfs_actions,
    bfs_actions_batched,
    bfs_actions_from_state,
    ezpolicy,
    ezpolicy_batched,
    get_action_BFS,
)
from .wrappers import DictAgentEnv, GymMultiAgentEnv

__version__ = "0.1.0"


def make_env(
    scenario_name: str = "basic_formation_env",
    benchmark: bool = False,
    num_agents: int = 3,
    auto_reset: bool = True,
    discrete_action: bool = False,
    discrete_action_input: bool = False,
    force_discrete_action: bool = False,
    **scenario_kwargs,
) -> FormationEnv:
    """Build a single functional env by scenario name.

    Signature-compatible with the reference factory
    (``formation_gym/__init__.py:6-17``), with scenario kwargs
    (``episode_length``, ``num_landmarks``, …) AND env-level options
    (``auto_reset``, ``discrete_action``) reachable — unlike the reference,
    where ``make_world`` defaults are hard-coded (SURVEY §8.6).
    """
    scenario = make_scenario(scenario_name, num_agents=num_agents, **scenario_kwargs)
    return FormationEnv(
        scenario,
        benchmark=benchmark,
        auto_reset=auto_reset,
        discrete_action=discrete_action,
        discrete_action_input=discrete_action_input,
        force_discrete_action=force_discrete_action,
    )


def make_vec_env(
    scenario_name: str = "formation_hd_env",
    num_envs: int = 4096,
    benchmark: bool = False,
    num_agents: int = 3,
    sharding=None,
    **scenario_kwargs,
) -> VecFormationEnv:
    """Build a vectorized env batch — the single-program replacement for the
    reference's SubprocVecEnv worker fleets (SURVEY §2.11)."""
    env = make_env(
        scenario_name, benchmark=benchmark, num_agents=num_agents, **scenario_kwargs
    )
    return VecFormationEnv(env, num_envs, sharding=sharding)


__all__ = [
    "EnvState",
    "StepOut",
    "WorldCfg",
    "FormationEnv",
    "VecFormationEnv",
    "GymMultiAgentEnv",
    "DictAgentEnv",
    "SCENARIOS",
    "spaces",
    "make_env",
    "make_vec_env",
    "make_scenario",
    "register",
    "rollout",
    "rollout_statepolicy",
    "rollout_statepolicy_rewardsum",
    "rollout_stateonly",
    "generate_shape",
    "ezpolicy",
    "ezpolicy_batched",
    "bfs_actions",
    "bfs_actions_batched",
    "bfs_actions_from_state",
    "get_action_BFS",
]
