"""`formation_hd_env`: Hausdorff-distance formation control (primary workload).

A rebuild of the reference's ``formation_gym/envs/formation_hd_env.py``:
agents must mimic the *shape* (translation-invariant topology) of a landmark
constellation while tracking a shared target velocity and avoiding collisions.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import EnvState, make_world_cfg
from ..ops.distances import center, hausdorff
from .scenario import Scenario

Array = jnp.ndarray

# Default per-layer triangle shapes for fractal target synthesis
# (reference ``formation_hd_env.py:125-130``).
DEFAULT_LAYER_SHAPES = np.array(
    [
        [[0, -1], [0.5, 0], [0, 1]],
        [[0, 1.6], [-1, 0], [1, 0]],
        [[1.5, 0], [0, 0], [-1.5, 0]],
        [[0, 0.6], [1, 0], [-1, 0]],
    ],
    dtype=np.float64,
)


def generate_shape(layer: int, layer_shapes: np.ndarray = None, *, fix_recursion: bool = False):
    """Recursive fractal composition of per-layer target shapes.

    ``shape[l] = layer_shapes[l][i] + 0.45 * shape[l-1]`` for each of the
    per-layer points i (reference ``formation_hd_env.py:123-139``).  Returns a
    nested ``[n, ..., n, 2]`` array exactly like the reference; callers
    ``.reshape(-1, 2)``.

    By default this reproduces the reference quirk that custom
    ``layer_shapes`` apply only to the *top* layer (the recursive call drops
    the argument — ``formation_hd_env.py:137``, SURVEY §8.8); pass
    ``fix_recursion=True`` to propagate custom shapes to every layer.
    """
    shapes = DEFAULT_LAYER_SHAPES if layer_shapes is None else np.asarray(layer_shapes, np.float64)
    assert layer < shapes.shape[0], "Layer shape is not enough!"
    base_chain = shapes if (fix_recursion or layer_shapes is None) else DEFAULT_LAYER_SHAPES
    # layer 0 IS the top layer: custom shapes apply (reference returns
    # layer_shapes[0] directly, ``formation_hd_env.py:134-135``)
    shape = shapes[0] if layer == 0 else base_chain[0]
    for l in range(1, layer + 1):
        lvl = shapes if l == layer else base_chain
        shape = np.stack([lvl[l][i] + shape * 0.45 for i in range(lvl.shape[1])])
    return shape


class FormationHDScenario(Scenario):
    """Reward = −Hausdorff(centered agents, ideal shape) − ‖ideal_vel −
    mean_vel‖ − 1 per collision (``formation_hd_env.py:61-75``); the collision
    threshold is the halved ``(s1+s2)/2`` variant (``:119-121``)."""

    name = "formation_hd_env"
    collision_factor = 0.5

    def __init__(self, num_agents: int = 3, episode_length: int = 100, dtype=jnp.float32):
        # World properties: ``formation_hd_env.py:13-33`` (agent size 0.03,
        # landmark size 0.01, landmarks non-collide/static, agents silent).
        self.cfg = make_world_cfg(
            num_agents,
            num_agents,
            agent_size=0.03,
            landmark_size=0.01,
            world_length=episode_length,
        )
        self.dtype = dtype
        self.obs_dim = 6 * num_agents

    def reset(self, key: Array) -> EnvState:
        """Draw order mirrors ``reset_world`` (``formation_hd_env.py:77-95``):
        agent positions, landmark positions (which double as the ideal shape
        before centering), then the shared ideal velocity."""
        n = self.n
        k1, k2, k3, carry = jax.random.split(key, 4)
        apos = self._uniform(k1, (n, 2))
        lpos = self._uniform(k2, (n, 2))
        state = self.zero_state(carry)
        return state.replace(
            pos=jnp.concatenate([apos, lpos]),
            ideal_shape=lpos - lpos.mean(axis=0),
            ideal_vel=self._uniform(k3, (2,)),
        )

    def pre_obs(self, state: EnvState) -> EnvState:
        """Recenter landmarks onto the agents' centroid — the obs-callback
        state mutation of ``formation_hd_env.py:40-44`` (visualization aid),
        hoisted into an explicit phase.  Idempotent within a step."""
        apos, lpos = self.agent_pos(state), self.landmark_pos(state)
        delta = apos.mean(axis=0) - lpos.mean(axis=0)
        return state.replace(
            pos=jnp.concatenate([apos, lpos + delta[None, :]])
        )

    def observe(self, state: EnvState) -> Array:
        """[N, 6N]: [p_vel(2) | others_rel(2N−2) | comm(2N−2) |
        ideal_shape(2N) | ideal_vel(2)] (``formation_hd_env.py:38-59``)."""
        n = self.n
        flat_shape = jnp.broadcast_to(state.ideal_shape.reshape(-1), (n, 2 * n))
        ivel = jnp.broadcast_to(state.ideal_vel, (n, 2))
        return jnp.concatenate(
            [
                self.agent_vel(state),
                self._others_rel(self.agent_pos(state)),
                self._others_comm(state),
                flat_shape,
                ivel,
            ],
            axis=1,
        )

    def reward(self, state: EnvState) -> Array:
        apos = self.agent_pos(state)
        haus, ncoll = self._hd_stats()(apos, state.ideal_shape)
        vel_term = -jnp.linalg.norm(state.ideal_vel - self.agent_vel(state).mean(axis=0))
        shared = -haus + vel_term
        return shared - ncoll.astype(self.dtype)

    # -- fused reward statistics dispatch -----------------------------------
    def _hd_stats_xla(self, apos: Array, ishape: Array):
        """(hausdorff, per-agent collision count) — the plain XLA formulas
        (reference ``formation_hd_env.py:61-75``, ``:119-121``)."""
        haus = hausdorff(center(apos), ishape)
        d = jnp.linalg.norm(apos[:, None, :] - apos[None, :, :], axis=-1)
        s = jnp.asarray(self.cfg.size[: self.n], d.dtype)
        thresh = (s[:, None] + s[None, :]) * self.collision_factor
        coll = d < thresh
        ncoll = jnp.sum(coll & ~jnp.eye(self.n, dtype=bool), axis=1)
        return haus, ncoll.astype(apos.dtype)

    def _hd_stats(self):
        """Per-env (hausdorff, collision-count) fn; under ``vmap`` over the
        env batch it goes through :func:`ops.dispatch.choose`, which may pick
        the GPU reduction kernel (ops/gpu/pairwise.py), so the two
        [B, N, N] distance planes never reach device memory.  Mirrors the
        pair-force dispatch (core/physics.py)."""
        from ..core import physics as _physics
        from ..ops import dispatch

        # cached beside the pair-force wrappers, in the same bounded registry
        cache_key = ("hd_stats", id(self))
        hit = _physics._pallas_fns.get(cache_key)
        if hit is not None and hit[0] is self:
            return hit[1]

        n = self.n
        size = self.cfg.size[:n]
        uniform = bool((size == size[0]).all())
        thresh = float(2.0 * size[0] * self.collision_factor)

        @jax.custom_batching.custom_vmap
        def fn(apos, ishape):
            return self._hd_stats_xla(apos, ishape)

        @fn.def_vmap
        def _rule(axis_size, in_batched, apos_b, ishape_b):
            del axis_size, in_batched  # both come from the batched state
            from ..ops.gpu.pairwise import hd_stats_pairwise

            xla = lambda a, s: jax.vmap(self._hd_stats_xla)(a, s)
            ineligible = None
            if apos_b.dtype != jnp.float32:
                ineligible = f"the reward kernel takes float32 positions, not {apos_b.dtype}"
            elif not uniform:
                ineligible = "the reward kernel needs one agent size"
            kernel = lambda a, s, interpret=False: hd_stats_pairwise(
                a, s, thresh=thresh, interpret=interpret
            )
            out = dispatch.choose(
                kernel, xla, apos_b, ishape_b, entities=n, ineligible=ineligible
            )
            return out, (True, True)

        _physics._pallas_fns[cache_key] = (self, fn)  # keep self alive
        return fn
