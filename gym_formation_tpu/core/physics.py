"""Vectorized MPE point-mass physics.

A rewrite of the reference world step (``formation_gym/core.py:205-362``).
The reference walks an O(E²) Python double loop over entity pairs per step;
here the whole step is a handful of dense [E,E] tensor ops on one
environment, ``jax.vmap``-ed over the env batch by the caller, so XLA fuses
the entire step into a few kernels and the batch axis maps onto the mesh
shards.

All functions are pure: ``(pos, vel, u, key) -> (pos, vel)`` with the static
:class:`~gym_formation_tpu.core.types.WorldCfg` closed over.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import dispatch
from .types import WorldCfg, WallCfg

Array = jnp.ndarray

class _DispatchCache:
    """Bounded LRU for the per-cfg custom-vmap wrappers.

    Entries are ``key -> (owner, fn)`` where ``owner`` (the WorldCfg or
    scenario) is kept alive on purpose: keys are ``id()``-based, so an entry
    is valid only while its owner is.  The bound keeps a long-lived process
    that constructs scenarios in a loop from leaking one closure (plus its
    owner) per construction — evicted entries are simply re-built on the next
    dispatch."""

    def __init__(self, maxsize: int = 64):
        from collections import OrderedDict

        self.maxsize = maxsize
        self._d = OrderedDict()

    def get(self, key):
        hit = self._d.get(key)
        if hit is not None:
            self._d.move_to_end(key)
        return hit

    def __setitem__(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def __len__(self):
        return len(self._d)

    def clear(self):
        self._d.clear()


_pallas_fns = _DispatchCache()


def _collision_forces_dispatch(cfg: WorldCfg):
    """Per-cfg custom-vmap wrapper: the unbatched call lowers to the XLA
    path; a vmap over the env batch goes through :func:`ops.dispatch.choose`,
    which may pick the GPU pair kernel (ops/gpu/pairwise.py), so the
    [B, E, E] weight planes never reach device memory."""
    key = id(cfg)
    hit = _pallas_fns.get(key)
    if hit is not None and hit[0] is cfg:
        return hit[1]

    @jax.custom_batching.custom_vmap
    def fn(pos):
        return _collision_forces_xla(pos, cfg)

    @fn.def_vmap
    def _rule(axis_size, in_batched, pos_b):
        del axis_size
        from ..ops.gpu.pairwise import collision_forces_pairwise, sym_applicable

        xla = lambda p: jax.vmap(lambda q: _collision_forces_xla(q, cfg))(p)
        ineligible = None
        if pos_b.dtype != jnp.float32:
            ineligible = f"the pair kernel takes float32 positions, not {pos_b.dtype}"
        elif not sym_applicable(cfg):
            ineligible = (
                "the pair kernel needs one size and one mass with every "
                "entity colliding and movable"
            )
        kernel = lambda p, interpret=False: collision_forces_pairwise(
            p, cfg, interpret=interpret
        )
        out = dispatch.choose(
            kernel, xla, pos_b, entities=cfg.n_entities, ineligible=ineligible
        )
        return out, True

    _pallas_fns[key] = (cfg, fn)  # keep cfg alive: cache is keyed by id
    return fn


def _collide_subset(cfg: WorldCfg):
    """Static restriction of the pair computation to colliding entities.

    A pair contributes force only when BOTH ends have ``collide=True``
    (reference ``core.py:296-299`` returns early otherwise), and the
    membership is compile-time static.  In the hd scenarios landmarks don't
    collide, so at N=243 the live pair set is [243,243] of the [486,486]
    matrix — a 4x reduction with no sorting and bit-identical results
    (excluded pairs contribute exactly 0.0 in the full-matrix form).

    Returns ``None`` when every entity collides (no restriction), else
    ``(lo, hi, idx, sub_cfg)`` where ``lo:hi`` is used when the subset is
    contiguous (``idx`` is None) and ``idx`` is a static fancy index
    otherwise.
    """
    key = ("subset", id(cfg))
    hit = _pallas_fns.get(key)
    if hit is not None and hit[0] is cfg:
        return hit[1]

    collide = np.asarray(cfg.collide, bool)
    idx = np.where(collide)[0]
    if len(idx) == cfg.n_entities:
        result = None
    elif len(idx) == 0:
        result = (0, 0, None, None)
    else:
        import dataclasses

        k = len(idx)
        pick = lambda a: None if a is None else np.asarray(a)[idx]
        sub_cfg = dataclasses.replace(
            cfg,
            n_agents=k,
            n_landmarks=0,
            size=pick(cfg.size),
            movable=pick(cfg.movable),
            collide=pick(cfg.collide),
            mass=pick(cfg.mass),
            max_speed=pick(cfg.max_speed),
            # agent-only arrays are never read by the collision kernels; keep
            # them shape-consistent with the subset entity count
            act_coef=np.zeros(k),
            u_noise=np.zeros(k),
            c_noise=np.zeros(k),
            silent=np.ones(k, bool),
            sensitivity=np.ones(k),
        )
        contiguous = bool(np.all(np.diff(idx) == 1))
        result = (
            (int(idx[0]), int(idx[-1]) + 1, None, sub_cfg)
            if contiguous
            else (0, 0, idx, sub_cfg)
        )
    _pallas_fns[key] = (cfg, result)
    return result


def collision_forces(pos: Array, cfg: WorldCfg) -> Array:
    """Pairwise soft-contact forces (see :func:`_collision_forces_xla`).

    The computation is statically restricted to the colliding-entity subset
    (:func:`_collide_subset`); under ``vmap`` it may dispatch to the GPU
    pair kernel (:mod:`gym_formation_tpu.ops.dispatch`)."""
    sub = _collide_subset(cfg)
    if sub is None:
        return _collision_forces_dispatch(cfg)(pos)
    lo, hi, idx, sub_cfg = sub
    if sub_cfg is None:  # nothing collides
        return jnp.zeros_like(pos)
    if idx is None:
        f = _collision_forces_dispatch(sub_cfg)(pos[lo:hi])
        return jnp.zeros_like(pos).at[lo:hi].set(f)
    f = _collision_forces_dispatch(sub_cfg)(pos[idx])
    return jnp.zeros_like(pos).at[idx].set(f)


def _collision_forces_xla(pos: Array, cfg: WorldCfg) -> Array:
    """Pairwise soft-contact forces, summed per entity.  [E, P].

    Implements the softmax-penetration contact model of the reference
    (``core.py:288-322``): for entities i, j

        penetration = k * logaddexp(0, -(dist - (size_i+size_j)) / k)
        F_ij        = contact_force * (pos_i - pos_j) / dist * penetration

    with the mass-ratio split of ``core.py:314-318``.  For a movable pair the
    reference applies ``(m_j/m_i) * F`` to i and ``-(m_i/m_j) * F`` to j;
    since F is antisymmetric this is exactly ``force_on_i = Σ_j (m_j/m_i) *
    F_ij`` — an order-independent reduction, which is why the Python pair loop
    vectorizes without changing semantics.
    """
    eps = jnp.asarray(1e-12, pos.dtype) if cfg.nan_guard else jnp.asarray(0.0, pos.dtype)
    # Direct coordinate differences for the distances: exact, with no
    # gram-matrix cancellation.
    delta = pos[:, None, :] - pos[None, :, :]  # [E,E,P]
    dist = jnp.sqrt(jnp.sum(delta * delta, axis=-1))  # [E,E]
    size = jnp.asarray(cfg.size, pos.dtype)
    dist_min = size[:, None] + size[None, :]
    k = cfg.contact_margin
    penetration = jnp.logaddexp(0.0, -(dist - dist_min) / k) * k
    # contact_force * delta / dist * penetration; dist=0 on the diagonal is
    # masked below, off-diagonal dist=0 reproduces the reference NaN unless
    # nan_guard (core.py:310-312).
    coef = cfg.contact_force * penetration / jnp.maximum(dist, eps)
    collide = jnp.asarray(cfg.collide)
    movable = jnp.asarray(cfg.movable)
    mass = jnp.asarray(cfg.mass, pos.dtype)
    pair_ok = (
        collide[:, None]
        & collide[None, :]
        & (movable[:, None] | movable[None, :])
        & ~jnp.eye(cfg.n_entities, dtype=bool)
    )
    # Receiver i must be movable to feel a force (core.py:319-321).  When both
    # ends are movable the mass ratio m_j/m_i applies; when only i is movable
    # the raw force applies.
    ratio = jnp.where(movable[None, :], mass[None, :] / mass[:, None], 1.0)
    w = jnp.where(pair_ok & movable[:, None], coef * ratio, 0.0)  # [E,E]
    # Σ_j w_ij (p_i - p_j) as a weighted sum, which XLA fuses with the pair
    # terms above.  The rowsum(w)·p − W@P form is a difference of large
    # terms, needs a full-f32 matrix product, and ran slower on an H100
    # (PERF.md, kernel decisions).
    return jnp.einsum("ij,ijp->ip", w, delta)


def _wall_force_single(pos_e: Array, size_e: Array, wall: WallCfg, cfg: WorldCfg) -> Array:
    """Force from one wall on one entity (reference ``core.py:324-362``)."""
    prll, perp = (0, 1) if wall.orient == "H" else (1, 0)
    p = pos_e[prll]
    lo, hi = wall.endpoints
    beyond = (p < lo - size_e) | (p > hi + size_e)
    inside = (p >= lo) & (p <= hi)
    dist_past_end = jnp.where(p < lo, p - lo, p - hi)
    dist_past_end = jnp.where(inside, 0.0, dist_past_end)
    theta = jnp.where(
        inside, 0.0, jnp.arcsin(jnp.clip(dist_past_end / size_e, -1.0, 1.0))
    )
    dist_min = jnp.cos(theta) * size_e + 0.5 * wall.width
    delta = pos_e[perp] - wall.axis_pos
    dist = jnp.abs(delta)
    k = cfg.contact_margin
    penetration = jnp.logaddexp(0.0, -(dist - dist_min) / k) * k
    eps = 1e-12 if cfg.nan_guard else 0.0
    force_mag = cfg.contact_force * delta / jnp.maximum(dist, eps) * penetration
    f = jnp.zeros(2, pos_e.dtype)
    f = f.at[perp].set(jnp.cos(theta) * force_mag)
    f = f.at[prll].set(jnp.sin(theta) * jnp.abs(force_mag))
    return jnp.where(beyond, 0.0, f)


def wall_forces(pos: Array, cfg: WorldCfg) -> Array:
    """Sum of wall contact forces per entity.  [E, P].  Zero if no walls."""
    if not cfg.walls:
        return jnp.zeros_like(pos)
    size = jnp.asarray(cfg.size, pos.dtype)
    movable = jnp.asarray(cfg.movable)
    total = jnp.zeros_like(pos)
    for wall in cfg.walls:
        ghost_ok = True  # no ghost entities in any shipped scenario
        if not ghost_ok and not wall.hard:
            continue
        f = jax.vmap(lambda pe, se: _wall_force_single(pe, se, wall, cfg))(pos, size)
        total = total + jnp.where(movable[:, None], f, 0.0)
    return total


def action_forces(
    u: Array, cfg: WorldCfg, key: Optional[Array] = None
) -> Array:
    """Control forces for agents, padded with zeros for landmarks.  [E, P].

    ``F = mass * (accel or 1) * u (+ u_noise * N(0,1))`` — reference
    ``core.py:228-237``.
    """
    coef = jnp.asarray(cfg.act_coef, u.dtype)
    f_agents = coef[:, None] * u
    if key is not None and np.any(cfg.u_noise > 0):
        noise = jax.random.normal(key, u.shape, u.dtype) * jnp.asarray(
            cfg.u_noise, u.dtype
        )[:, None]
        f_agents = f_agents + noise
    pad = jnp.zeros((cfg.n_landmarks, u.shape[-1]), u.dtype)
    return jnp.concatenate([f_agents, pad], axis=0)


def integrate(pos: Array, vel: Array, force: Array, cfg: WorldCfg) -> Tuple[Array, Array]:
    """Damped semi-implicit Euler with per-entity speed clamp
    (reference ``core.py:264-277``).  Non-movable entities keep pos/vel."""
    movable = jnp.asarray(cfg.movable)[:, None]
    mass = jnp.asarray(cfg.mass, pos.dtype)[:, None]
    new_vel = vel * (1.0 - cfg.damping) + (force / mass) * cfg.dt
    max_speed = jnp.asarray(cfg.max_speed, pos.dtype)
    if np.any(np.isfinite(cfg.max_speed)):
        speed = jnp.linalg.norm(new_vel, axis=-1, keepdims=True)
        scale = jnp.where(
            speed > max_speed[:, None], max_speed[:, None] / jnp.maximum(speed, 1e-12), 1.0
        )
        new_vel = new_vel * scale
    new_vel = jnp.where(movable, new_vel, vel)
    new_pos = jnp.where(movable, pos + new_vel * cfg.dt, pos)
    return new_pos, new_vel


def world_step(
    pos: Array,
    vel: Array,
    u: Array,
    cfg: WorldCfg,
    key: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """One physics step for a single environment.

    Equivalent to ``World.step`` (``core.py:205-225``) minus scripted agents
    and comm-state update (the env layer handles comm; no shipped scenario
    uses scripted agents).

    Args:
      pos, vel: [E, P] entity state, agents first.
      u: [n_agents, P] control (already sensitivity-scaled by the env layer,
        matching ``environment.py:218-221``).
      key: optional PRNG key for motor noise.
    """
    force = action_forces(u, cfg, key)
    force = force + collision_forces(pos, cfg)
    if cfg.walls:
        force = force + wall_forces(pos, cfg)
    return integrate(pos, vel, force, cfg)
