"""Batched geometric primitives shared by scenarios and policies.

These replace the reference's per-pair Python loops and its
``scipy.spatial.distance.directed_hausdorff`` calls
(``formation_gym/envs/formation_hd_env.py:61-75``) with dense matrix
reductions that XLA fuses, and that vmap cleanly over an environment batch.
"""

from __future__ import annotations

import jax.numpy as jnp

Array = jnp.ndarray


def pairwise_dists(a: Array, b: Array) -> Array:
    """Euclidean distance matrix between point sets a [N,P] and b [M,P] → [N,M]."""
    delta = a[..., :, None, :] - b[..., None, :, :]
    return jnp.linalg.norm(delta, axis=-1)


def hausdorff(a: Array, b: Array) -> Array:
    """Symmetric Hausdorff distance between point sets.

    ``max(directed(a,b), directed(b,a))`` where ``directed(u,v) = max_i min_j
    |u_i - v_j|`` — the exact quantity scipy's ``directed_hausdorff`` returns
    (its early-break randomization only affects runtime, not the value), as
    used in the formation reward (``envs/formation_hd_env.py:66``).
    """
    d = pairwise_dists(a, b)
    return jnp.maximum(jnp.min(d, axis=-1).max(axis=-1), jnp.min(d, axis=-2).max(axis=-1))


def center(points: Array) -> Array:
    """Subtract the centroid over the second-to-last axis (shape recentering,
    ``envs/formation_hd_env.py:65``)."""
    return points - jnp.mean(points, axis=-2, keepdims=True)


def block_means(points: Array, n_blocks: int) -> Array:
    """Mean over contiguous equal blocks: [..., N, P] → [..., n_blocks, P].

    The group-centroid coarsening of the hierarchical BFS policy
    (``/root/reference/formation_gym/__init__.py:69,74``).
    """
    *lead, n, p = points.shape
    return points.reshape(*lead, n_blocks, n // n_blocks, p).mean(axis=-2)
