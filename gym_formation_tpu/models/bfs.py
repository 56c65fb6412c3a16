"""Hierarchical BFS policy expansion as a level-batched kernel.

The reference ``get_action_BFS`` (``/root/reference/formation_gym/__init__.py:49-99``)
runs one n-agent policy recursively over n^L agents by treating group
centroids as meta-agents: a Python BFS queue issuing ``(n^L − 1)/(n − 1)``
sequential single-obs policy calls (121 for n=3, L=5 — README.md:31-51).

Formulation: all groups of one level are coarsened at once with a
segment-mean (``block_means``) and evaluated in ONE batched policy apply, so
the depth-L expansion costs L sequential applies total, each a large batch
that keeps the device busy.  Everything is static-shaped; the whole expansion jits
and vmaps over the env batch.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

Array = jnp.ndarray


def num_layers(num_agents: int, n_per_layer: int) -> int:
    """L such that n_per_layer**L == num_agents (asserts exactness, mirroring
    the reference's integer-log check ``__init__.py:55-56``)."""
    L = int(round(np.log(num_agents) / np.log(n_per_layer)))
    assert n_per_layer**L == num_agents, "Observation shape error!"
    return L


def bfs_actions(
    policy_fn: Callable[[Array], Array],
    obs: Array,
    n_per_layer: int,
) -> Array:
    """Expand one n-agent policy over n^L agents.  [N, 6N] obs → [N, 2] acts.

    ``policy_fn`` maps a batch of 6n-dim observations [M, 6n] → [M, 2]
    actions (e.g. :func:`~gym_formation_tpu.models.scripted.ezpolicy_batched`
    or a jitted network apply).

    Per level ℓ (root ℓ=0): each of the n^ℓ groups is split into n blocks;
    the block-centroid constellation (recentred per block, reference
    ``__init__.py:66-71``), block-mean ideal sub-shape (``:73-74``), block
    leader velocity (``:64-66``) and the parent's commanded velocity
    (``:76,95``) form a standard 6n-dim obs; the policy output ×(L−ℓ)
    (``:78-79``) becomes each block's commanded velocity.  Leaf outputs are
    the per-agent actions, emitted in agent order.
    """
    n = n_per_layer
    N = obs.shape[0]
    dt = obs.dtype
    # Common translation frame: agent 0's relative view with itself at the
    # origin (only centroid differences are ever used, so any frame works).
    P = jnp.concatenate(
        [jnp.zeros((1, 2), dt), obs[0, 2 : 2 * N].reshape(N - 1, 2)]
    )
    V = obs[:, :2]
    S = obs[0, 4 * N - 2 : 6 * N - 2].reshape(N, 2)
    parent_vel = obs[0, 6 * N - 2 :]  # root ideal velocity
    return _expand(policy_fn, P, V, S, parent_vel, n)


def bfs_actions_from_state(
    policy_fn: Callable[[Array], Array],
    scenario,
    state,
    n_per_layer: int,
) -> Array:
    """:func:`bfs_actions` fed directly from an ``EnvState`` — the same
    actions (to 1-ULP reduction reassociation), without materializing the
    [N, 6N] observation tensor.

    The expansion consumes exactly four O(N) state quantities (agent
    positions in any common frame, agent velocities, the ideal shape, the
    commanded root velocity); the full observation's O(N²) ``others_rel``
    replication is interface overhead for it.  At N=243 the obs tensor
    (354k floats/env/step) dominates memory traffic — this path removes it
    from scripted/hierarchical rollouts (`hd` scenario family: obs layout
    ``formation_hd_env.py:38-59``).
    """
    pos = scenario.agent_pos(state)
    P = pos - pos[0]  # == [0; others_rel of agent 0] (scenario._others_rel)
    return _expand(
        policy_fn,
        P,
        scenario.agent_vel(state),
        state.ideal_shape,
        state.ideal_vel,
        n_per_layer,
    )


def _expand(
    policy_fn: Callable[[Array], Array],
    P: Array,
    V: Array,
    S: Array,
    root_vel: Array,
    n: int,
) -> Array:
    """Level-batched BFS expansion core: positions [N,2] (any common frame),
    velocities [N,2], ideal shape [N,2], root commanded velocity [2]."""
    N = P.shape[0]
    L = num_layers(N, n)
    dt = P.dtype
    zeros_comm = jnp.zeros((2 * (n - 1),), dt)

    parent_vel = root_vel[None, :]  # [1, 2]
    out = None
    for l in range(L):
        G = n**l
        m = N // (G * n)  # block size at this level
        C = P.reshape(G, n, m, 2).mean(axis=2)  # [G, n, 2] block centroids
        T = S.reshape(G, n, m, 2).mean(axis=2)  # [G, n, 2] block targets
        leaders = V.reshape(G, n, m, 2)[:, :, 0]  # [G, n, 2] leader velocities
        rel = C[:, None, :, :] - C[:, :, None, :]  # [G, i, k, 2] = C_k − C_i
        # drop block i from its own centroid list via static slices (a
        # take_along_axis here would lower to a dynamic gather, which a
        # compile-time-constant index pattern does not need)
        cur_shape = jnp.stack(
            [
                jnp.concatenate([rel[:, i, :i], rel[:, i, i + 1 :]], axis=1)
                for i in range(n)
            ],
            axis=1,
        ).reshape(G, n, 2 * (n - 1))
        obs_in = jnp.concatenate(
            [
                leaders,
                cur_shape,
                jnp.broadcast_to(zeros_comm, (G, n, 2 * (n - 1))),
                jnp.broadcast_to(T.reshape(G, 1, 2 * n), (G, n, 2 * n)),
                jnp.broadcast_to(parent_vel[:, None, :], (G, n, 2)),
            ],
            axis=-1,
        ).reshape(G * n, 6 * n)
        out = policy_fn(obs_in) * (L - l)
        parent_vel = out  # next level has G*n groups
    return out  # [N, 2], row g*n+i == agent g*n+i (BFS leaf order)


def bfs_actions_batched(
    policy_fn: Callable[[Array], Array], obs: Array, n_per_layer: int
) -> Array:
    """[B, N, 6N] → [B, N, 2] (vmapped :func:`bfs_actions`)."""
    return jax.vmap(lambda o: bfs_actions(policy_fn, o, n_per_layer))(obs)


def get_action_BFS(policy, obs, num_agents_per_layer: int):
    """Reference-signature convenience wrapper (``__init__.py:49``): ``obs``
    is a list/array of N per-agent observation vectors and ``policy`` maps a
    single obs → action.  Returns a list of per-agent action arrays."""
    obs = jnp.asarray(np.stack(obs))
    batched = lambda o: jnp.stack([jnp.asarray(policy(r)) for r in o])
    acts = bfs_actions(batched, obs, num_agents_per_layer)
    return list(np.asarray(acts))
