"""Factorized first layers for the hd observation — obs-free MAPPO.

The formation_hd observation is a *linear* repackaging of O(N) state
(``envs/formation_hd.py:observe``, reference ``formation_hd_env.py:38-59``):

    obs_i = [vel_i(2) | p_k − p_i for k≠i (2N−2) | comm=0 (2N−2) |
             flat ideal_shape (2N) | ideal_vel (2)]

so the first Dense layer's product ``obs_i @ W`` never needs the 6N-dim
observation materialized.  Writing ``W̃[j] = W[2+2j : 4+2j]`` for the
others_rel slot blocks and noting the slot of neighbor k in agent i's view
is ``σ_i(k) = k − (k > i)``:

    Σ_{k≠i} (p_k − p_i) @ W̃[σ_i(k)]
      = Σ_{k<i} p_k @ W̃[k]  +  Σ_{k>i} p_k @ W̃[k−1]  −  p_i @ U
    where U = Σ_{j≤N−2} W̃[j]   (the slot sum is i-independent!)

— a prefix sum and a suffix sum over agents, O(N·H) instead of the naive
O(N²·H).  The comm block contributes exactly zero (silent agents), the
shape/ideal_vel blocks are shared across agents.  For the centralized
critic (``share_obs = concat_i obs_i``) the cross terms collapse further:

    Σ_i Σ_{k≠i} (p_k − p_i) @ W̃_i[σ_i(k)] = Σ_k p_k @ V_k − Σ_i p_i @ U_i

with ``V_k = Σ_{i≠k} W̃_i[σ_i(k)]`` and ``U_i = Σ_j W̃_i[j]`` — both
*parameter-only* (precomputed once per update, not per sample).

At N=243 this turns the actor+critic first layers from 2 × 22.7 M MACs per
env-step into ~0.3 M, and — more importantly — removes the
``[T·B, N, 1458]`` observation tensor from the trajectory entirely (the
update stores ~12 floats per agent of state instead of 1458 of obs).

Everything here is exact linear algebra: parity with ``obs @ W + b`` holds
to f32 reassociation (tests/test_structured_obs.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .networks import soft_bound

Array = jnp.ndarray


def _split_actor_w(W: Array, n: int):
    """Rows of the first Dense kernel by hd-obs block (comm rows dropped —
    silent agents make that block identically zero)."""
    Wv = W[0:2]
    Wr = W[2 : 2 * n].reshape(n - 1, 2, -1)  # slot blocks W̃[j]
    Ws = W[4 * n - 2 : 6 * n - 2]
    Wi = W[6 * n - 2 : 6 * n]
    return Wv, Wr, Ws, Wi


def hd_actor_h1(W: Array, b: Array, apos, avel, ishape, ivel, dtype=None) -> Array:
    """``obs @ W + b`` for every agent without building obs.

    apos/avel/ishape: [..., N, 2]; ivel: [..., 2].  Returns [..., N, H].

    ``dtype=jnp.bfloat16`` runs the block einsums and returns h1 in bf16
    (MAPPOConfig.structured_bf16): halves the matrix-unit work and the
    memory traffic of the [M, N, H] activations that dominate the N=243
    update.  Positions are O(1)-scaled, so bf16's
    8-bit mantissa costs ~3 decimal digits on h1 — a training-math change,
    default off.
    """
    n = apos.shape[-2]
    if dtype is not None:
        W, apos, avel, ishape, ivel = (
            x.astype(dtype) for x in (W, apos, avel, ishape, ivel)
        )
        b = b.astype(dtype)
    Wv, Wr, Ws, Wi = _split_actor_w(W, n)
    # prefix + suffix in ONE triangle.  The running sums are triangular
    # matrix products rather than jnp.cumsum, which can lower to an N-step
    # sequential scan.  With a_k = p_k@W̃[k] and b'_j = p_{j+1}@W̃[j],
    # P1_i = Σ_{k<i} a_k and S1_i = Σ_{j≥i} b'_j = TOT − Σ_{j<i} b'_j, so
    #     P1_i + S1_i = TOT + Σ_{k<i} (a_k − b'_k)
    # and a_k − b'_k = (p_k − p_{k+1})@W̃[k]: one slot-block einsum and one
    # [N, N-1] triangle contraction instead of two of each.  The triangles
    # are the dominant MACs of the whole N=243 update (96 G/epoch each at
    # B=1024 in forward alone); this form is exact up to f32 reassociation
    # (parity in tests/test_structured_obs.py).  These products take the
    # device's default matmul precision, like the rest of the learner.
    diff = apos[..., : n - 1, :] - apos[..., 1:, :]
    d = jnp.einsum("...kc,kch->...kh", diff, Wr)  # a_k − b'_k
    tot = jnp.einsum("...kc,kch->...h", apos[..., 1:, :], Wr)  # TOT
    i_idx = jnp.arange(n)[:, None]
    j_idx = jnp.arange(n - 1)[None, :]
    tri_lo = (j_idx < i_idx).astype(d.dtype)  # [N, N-1]: strict lower
    P = jnp.einsum("ik,...kh->...ih", tri_lo, d)  # Σ_{k<i} (a_k − b'_k)
    U = Wr.sum(axis=0)  # [2, H]
    shared = (
        ishape.reshape(*ishape.shape[:-2], 2 * n) @ Ws + ivel @ Wi + b + tot
    )  # [..., H] — per-env terms the obs broadcasts to every agent
    return (
        avel @ Wv
        + P
        - apos @ U
        + shared[..., None, :]
    )


def _critic_vu(Wc: Array, n: int):
    """Parameter-only precomputes for the critic cross terms: (V [N,2,H],
    U [N,2,H], Wv_i, Ws_sum, Wi_sum).  Cost O(N²·H) once per update."""
    H = Wc.shape[-1]
    Wb = Wc.reshape(n, 6 * n, H)
    Wv_i = Wb[:, 0:2]  # [N, 2, H]
    Wr_i = Wb[:, 2 : 2 * n].reshape(n, n - 1, 2, H)  # A_i[j] = W̃_i[j]
    Ws_sum = Wb[:, 4 * n - 2 : 6 * n - 2].sum(axis=0)  # [2N, H]
    Wi_sum = Wb[:, 6 * n - 2 : 6 * n].sum(axis=0)  # [2, H]
    U_i = Wr_i.sum(axis=1)  # [N, 2, H]
    # V_k = Σ_{i>k} A_i[k] + Σ_{i<k} A_i[k−1] — built with masked einsums
    # and pads only (a diagonal gather here would put a scatter in the
    # backward pass, which runs inside jax.grad every epoch)
    i_idx = jnp.arange(n)[:, None]
    j_idx = jnp.arange(n - 1)[None, :]
    dt = Wr_i.dtype
    C1 = jnp.einsum(
        "ijch,ij->jch", Wr_i, (i_idx > j_idx).astype(dt)
    )  # C1[j] = Σ_{i>j} A_i[j]
    C2p = jnp.einsum(
        "ijch,ij->jch", Wr_i, (i_idx <= j_idx).astype(dt)
    )  # C2p[j] = Σ_{i≤j} A_i[j]
    z = jnp.zeros_like(C1[:1])
    V = jnp.concatenate([C1, z], axis=0) + jnp.concatenate([z, C2p], axis=0)
    return Wv_i, U_i, V, Ws_sum, Wi_sum


def hd_critic_h1(Wc: Array, bc: Array, apos, avel, ishape, ivel) -> Array:
    """``share_obs @ Wc + bc`` without building share_obs.  [..., H]."""
    n = apos.shape[-2]
    Wv_i, U_i, V_k, Ws_sum, Wi_sum = _critic_vu(Wc, n)
    return (
        jnp.einsum("...ic,ich->...h", avel, Wv_i)
        + jnp.einsum("...kc,kch->...h", apos, V_k)
        - jnp.einsum("...ic,ich->...h", apos, U_i)
        + ishape.reshape(*ishape.shape[:-2], 2 * n) @ Ws_sum
        + ivel @ Wi_sum
        + bc
    )


def _mlp_tail(p_mlp, h1pre, n_layers: int, dtype=None) -> Array:
    """Finish the MLP given the first layer's pre-activation (mirrors
    networks.MLP: Dense → relu per layer, no layer norm)."""
    h = jax.nn.relu(h1pre)
    for i in range(1, n_layers):
        d = p_mlp[f"Dense_{i}"]
        k, bi = d["kernel"], d["bias"]
        if dtype is not None:
            k, bi = k.astype(dtype), bi.astype(dtype)
        h = jax.nn.relu(h @ k + bi)
    return h


def actor_forward_structured(params, apos, avel, ishape, ivel, hidden,
                             dtype=None):
    """GaussianActor forward from state parts — identical math to
    ``GaussianActor.apply(params, obs)`` on the hd observation (bf16
    compute when ``dtype`` is set; the distribution parameters return
    in f32 either way)."""
    p = params["params"]
    d0 = p["MLP_0"]["Dense_0"]
    h1 = hd_actor_h1(d0["kernel"], d0["bias"], apos, avel, ishape, ivel,
                     dtype=dtype)
    h = _mlp_tail(p["MLP_0"], h1, len(hidden), dtype=dtype)
    kh, bh = p["Dense_0"]["kernel"], p["Dense_0"]["bias"]
    if dtype is not None:
        kh, bh = kh.astype(dtype), bh.astype(dtype)
    mean = (h @ kh + bh).astype(jnp.float32)
    log_std = soft_bound(p["log_std"], -5.0, 2.0)
    return mean, jnp.broadcast_to(log_std, mean.shape)


def critic_forward_structured(params, apos, avel, ishape, ivel, hidden):
    """ValueCritic forward from state parts — identical math to
    ``ValueCritic.apply(params, share_obs)``."""
    p = params["params"]
    d0 = p["MLP_0"]["Dense_0"]
    h1 = hd_critic_h1(d0["kernel"], d0["bias"], apos, avel, ishape, ivel)
    h = _mlp_tail(p["MLP_0"], h1, len(hidden))
    return (h @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"]).squeeze(-1)
