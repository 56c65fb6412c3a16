"""Scripted greedy formation policy (`ezpolicy`).

Batched rebuild of ``/root/reference/formation_gym/__init__.py:19-47``: parse
the 6N-dim hd observation, greedily pick the ideal-shape vertex this agent
should claim (closest-agent assignment with a seniority tiebreak), and emit a
proportional control plus an ideal-velocity feedforward.  The reference runs
one obs vector at a time through a Python loop with an early ``break``; here
the argsort/argmin logic is expressed as masked reductions so it vmaps over
agents × envs and runs on device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jnp.ndarray


def parse_hd_obs(obs: Array, num_agents: int):
    """Split a 6N-dim formation_hd observation into its named parts.

    Layout (``envs/formation_hd_env.py:59``): [p_vel(2) | others_rel(2N−2) |
    comm(2N−2) | ideal_shape(2N) | ideal_vel(2)].
    """
    n = num_agents
    p_vel = obs[..., :2]
    other_pos = obs[..., 2 : 2 * n]
    ideal_shape = obs[..., 4 * n - 2 : 6 * n - 2].reshape(*obs.shape[:-1], n, 2)
    ideal_vel = obs[..., 6 * n - 2 :]
    return p_vel, other_pos, ideal_shape, ideal_vel


def ezpolicy(obs: Array, num_agents: int = None) -> Array:
    """Action for one agent from its [6N] observation (vmap for batches).

    Faithful to the reference greedy loop (``__init__.py:35-40``): walk the
    ideal vertices in order of distance from self; claim the first whose
    nearest agent is self, falling back to the farthest-ranked vertex.  Then
    ``act = clip(0.5 * (vertex − self), ±1)`` plus the ideal velocity scaled
    by 1.0 when the formation error < 0.01 else 0.3 (``:42-46``).
    """
    if num_agents is None:
        assert obs.shape[-1] % 6 == 0, obs.shape
        num_agents = obs.shape[-1] // 6
    n = num_agents
    _, other_pos, ideal_shape, ideal_vel = parse_hd_obs(obs, n)
    ideal_shape = ideal_shape - ideal_shape.mean(axis=-2, keepdims=True)
    # Current shape in self frame: others then self at the *end* (``:31-33``).
    cur = jnp.concatenate([other_pos.reshape(n - 1, 2), jnp.zeros((1, 2), obs.dtype)])
    cur = cur - cur.mean(axis=0, keepdims=True)
    me = cur[-1]
    # The reference walks vertices ranked by distance-from-self and claims
    # the first whose closest agent is self, falling back to the last-ranked
    # (farthest) vertex.  "First ranked with ok" ≡ "argmin of d_self over ok
    # vertices" (argsort and argmin break ties identically: lowest index), so
    # the rank walk is a masked argmin — no sort/scatter/dynamic-gather.
    d_self = jnp.linalg.norm(me[None, :] - ideal_shape, axis=-1)  # [vertex]
    d_agent_vertex = jnp.linalg.norm(
        cur[:, None, :] - ideal_shape[None, :, :], axis=-1
    )  # [agent, vertex]
    closest = jnp.argmin(d_agent_vertex, axis=0)
    ok = closest == (n - 1)
    # fallback vertex = farthest from self (``idx == sort_mark_idx[-1]``);
    # argsort ranks ties by index so its last element is the *highest* index
    # among maximal distances — mirror that with a reversed argmax.
    far = (n - 1) - jnp.argmax(d_self[::-1])
    ok = ok | (jnp.arange(n) == far)
    pick = jnp.argmin(jnp.where(ok, d_self, jnp.inf))
    vertex = jnp.einsum(
        "v,vd->d", jax.nn.one_hot(pick, n, dtype=ideal_shape.dtype), ideal_shape
    )
    act = jnp.clip(0.5 * (vertex - me), -1.0, 1.0)
    settled = jnp.linalg.norm(ideal_shape - cur) < 0.01
    return act + ideal_vel * jnp.where(settled, 1.0, 0.3)


def ezpolicy_batched(obs: Array) -> Array:
    """[..., N, 6N] observations → [..., N, 2] actions (vmapped ezpolicy)."""
    n = obs.shape[-1] // 6
    fn = lambda o: ezpolicy(o, n)
    for _ in range(obs.ndim - 1):
        fn = jax.vmap(fn)
    return fn(obs)
