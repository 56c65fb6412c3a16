"""Core state / configuration types for the formation engine.

Design note
-----------
The reference (``/root/reference/formation_gym/core.py:4-154``) models the
world as Python object graphs: lists of ``Agent``/``Landmark`` entities, each
holding its own numpy state.  That representation cannot be traced by XLA.
Here the world is a single struct-of-arrays pytree (:class:`EnvState`) over
*all* entities (agents first, then landmarks — same ordering as
``World.entities``, ``core.py:141-144``), and all per-entity constants live in
a static :class:`WorldCfg` that jitted step functions close over.  A batch of
environments is simply ``jax.vmap`` over the leading axis of the pytree, and a
multi-host fleet is the same pytree sharded over a ``jax.sharding.Mesh``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp
from . import struct

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class WallCfg:
    """Static wall description (reference ``core.py:27-41``).

    ``orient`` 'H' → wall lies along x (parallel dim 0, perpendicular dim 1);
    'V' → along y.
    """

    orient: str = "H"
    axis_pos: float = 0.0
    endpoints: Tuple[float, float] = (-1.0, 1.0)
    width: float = 0.1
    hard: bool = True


@dataclasses.dataclass(frozen=True)
class WorldCfg:
    """Static world/entity configuration.

    Mirrors the tunables of the reference ``World`` (``core.py:112-139``) and
    per-entity properties (``core.py:45-109``), flattened into per-entity
    arrays indexed ``[0, n_agents)`` = agents, ``[n_agents, n_entities)`` =
    landmarks (including movable "obstacle" landmarks).

    These arrays are *compile-time constants*: step functions close over them,
    so XLA folds all masks/coefficients into the compiled program.
    """

    n_agents: int
    n_landmarks: int
    dim_p: int = 2
    dim_c: int = 2
    dt: float = 0.1
    damping: float = 0.25
    contact_force: float = 100.0
    contact_margin: float = 1e-3
    world_length: int = 50
    collaborative: bool = True
    # Per-entity static properties, shape [n_entities].
    size: np.ndarray = None
    movable: np.ndarray = None
    collide: np.ndarray = None
    mass: np.ndarray = None
    # mass * (accel if accel is not None else 1): force coefficient applied to
    # the control input (reference ``core.py:228-237``).
    act_coef: np.ndarray = None
    max_speed: np.ndarray = None  # np.inf where unset
    u_noise: np.ndarray = None  # [n_agents], 0 where unset
    c_noise: np.ndarray = None  # [n_agents], 0 where unset
    silent: np.ndarray = None  # [n_agents] bool
    # Control sensitivity applied by the env action decode BEFORE the physics'
    # own act_coef factor (reference ``environment.py:218-221``: 5.0 unless the
    # agent sets ``accel``, in which case accel is applied twice — once here,
    # once in ``apply_action_force``).  [n_agents]; None → the env falls back
    # to the accel-derived rule for hand-built configs.
    sensitivity: np.ndarray = None
    u_range: float = 1.0
    walls: Tuple[WallCfg, ...] = ()
    # Native mode guards the 0/0 at zero separation (known NaN in the
    # reference, ``core.py:310-312`` / train/README.md:194-205).  Exact-match
    # harnesses set this False to reproduce the reference bit stream.
    nan_guard: bool = True

    @property
    def n_entities(self) -> int:
        return self.n_agents + self.n_landmarks

    def has_noise(self) -> bool:
        return bool(np.any(self.u_noise > 0) or np.any(self.c_noise > 0))


def make_world_cfg(
    n_agents: int,
    n_landmarks: int,
    *,
    agent_size: float = 0.05,
    landmark_size=0.05,
    agent_collide: bool = True,
    landmark_collide=False,
    landmark_movable=False,
    agent_accel: Optional[float] = None,
    agent_max_speed: Optional[float] = None,
    silent: bool = True,
    **kw,
) -> WorldCfg:
    """Build a :class:`WorldCfg` from scenario-level scalars.

    ``landmark_size``/``landmark_collide``/``landmark_movable`` may be scalars
    or per-landmark sequences (used by the obstacle scenario where entity
    properties differ within the landmark block).
    """
    e = n_agents + n_landmarks

    def fill(n, v, dtype=np.float64):
        a = np.asarray(v, dtype=dtype)
        return np.full((n,), a, dtype=dtype) if a.ndim == 0 else a.astype(dtype)

    size = np.concatenate([fill(n_agents, agent_size), fill(n_landmarks, landmark_size)])
    collide = np.concatenate(
        [fill(n_agents, agent_collide, bool), fill(n_landmarks, landmark_collide, bool)]
    )
    movable = np.concatenate(
        [np.ones(n_agents, bool), fill(n_landmarks, landmark_movable, bool)]
    )
    mass = np.ones(e)
    accel = 1.0 if agent_accel is None else agent_accel
    act_coef = mass[:n_agents] * accel
    # explicit, not inferred: 5.0 when accel is unset (the reference default),
    # else accel (environment.py:218-221)
    sensitivity = fill(n_agents, 5.0 if agent_accel is None else agent_accel)
    max_speed = np.full(e, np.inf)
    if agent_max_speed is not None:
        max_speed[:n_agents] = agent_max_speed
    return WorldCfg(
        n_agents=n_agents,
        n_landmarks=n_landmarks,
        size=size,
        movable=movable,
        collide=collide,
        mass=mass,
        act_coef=act_coef,
        max_speed=max_speed,
        u_noise=np.zeros(n_agents),
        c_noise=np.zeros(n_agents),
        silent=np.full(n_agents, silent),
        sensitivity=sensitivity,
        **kw,
    )


@struct.dataclass
class EnvState:
    """Complete per-environment dynamic state (a JAX pytree).

    Replaces the reference's scattered mutable state: entity ``state.p_pos`` /
    ``state.p_vel`` (``core.py:4-16``), agent comm state ``c``, the scenario's
    ``ideal_shape``/``ideal_vel`` attributes
    (``envs/formation_hd_env.py:86-95``), and the env step counter
    (``environment.py:23,114``).  RNG is an explicit per-env key instead of
    the reference's *global* ``np.random`` (``environment.py:106-110``).
    """

    pos: Array  # [n_entities, dim_p]
    vel: Array  # [n_entities, dim_p]
    c: Array  # [n_agents, dim_c] communication utterances
    ideal_shape: Array  # [n_landmarks, dim_p]; zeros where unused
    ideal_vel: Array  # [dim_p]; zeros where unused
    t: Array  # i32 scalar: steps since episode start
    key: Array  # jax PRNG key

    @property
    def n_entities(self) -> int:
        return self.pos.shape[-2]


@struct.dataclass
class StepOut:
    """Result of one env step — the (obs_n, reward_n, done_n, info_n) tuple of
    the reference ``MultiAgentEnv.step`` (``environment.py:113-142``) as a
    batched pytree."""

    obs: Array  # [n_agents, obs_dim]
    reward: Array  # [n_agents] (shared-reward broadcast already applied)
    done: Array  # [n_agents] bool
    info: dict  # str -> Array; includes 'individual_reward' [n_agents]
