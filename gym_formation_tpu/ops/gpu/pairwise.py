"""Pairwise soft-contact forces and hd reward statistics for the GPU
(Pallas through Triton).

XLA's plain path builds the per-env ``[E, E]`` pair planes in device memory:
at N=243 and 4096 envs that is a ``[4096, 243, 243]`` weight matrix and its
batched ``W @ P`` every step, plus two ``[4096, 243, 243]`` distance planes
for the reward.  These kernels give each env (or each env and row tile) one
program that holds that env's positions, sweeps the column tiles in registers
and writes only O(E) results: the ``[E, 2]`` forces, or the two directed
Hausdorff maxima and the per-agent collision counts.  No pair plane reaches
device memory.

Both kernels pad the entity axis to a power of two with far-away, distinct
sentinel positions, so padded rows never touch a real entity or each other
and need no validity mask.

Semantics:

- :func:`collision_forces_pairwise` computes
  :func:`gym_formation_tpu.core.physics._collision_forces_xla` on the
  envelope of :func:`sym_applicable` (every entity collides and moves, one
  mass, one size): there the mass ratio is 1 and the force on i is
  ``sum_j coef_ij (p_i - p_j)``.  It takes 1/dist from ``rsqrt`` and the
  softplus tail from ``exp2`` and a polynomial, and agrees with the XLA
  path to ~3e-7 of max|F|.
- :func:`hd_stats_pairwise` equals
  ``FormationHDScenario._hd_stats_xla``: the Hausdorff distance between the
  centred agents and the ideal shape, and each agent's count of others
  closer than the uniform collision threshold.  Squared distances feed the
  minima (sqrt is monotone) and one sqrt is taken on the result.

``interpret=True`` runs either kernel through the Pallas interpreter on any
backend; tests use it on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...core.types import WorldCfg

Array = jnp.ndarray

_SENTINEL = 1e4  # spacing of the padded rows' positions

# Tile sizes and launch parameters, tuned on an H100 (PERF.md).  Blocks are
# powers of two.
FORCES_CONFIG = dict(tile_rows=32, tile_cols=32, num_warps=4, num_stages=1)
STATS_CONFIG = dict(tile=16, num_warps=1, num_stages=1)


def sym_applicable(cfg: WorldCfg) -> bool:
    """True when the force kernel is exact for ``cfg``: every entity
    collides, is movable, and shares one mass and one size."""
    return bool(
        np.all(cfg.collide)
        and np.all(cfg.movable)
        and np.all(np.asarray(cfg.mass) == cfg.mass[0])
        and np.all(np.asarray(cfg.size) == cfg.size[0])
    )


def padded_rows(n: int) -> int:
    """Entity rows after padding: the next power of two, at least 16."""
    return max(16, pl.next_power_of_2(n))


def _pad(a: Array, rows: int, sign: float) -> Array:
    """[B, n] -> [B, rows] f32; rows >= n sit at distinct far sentinels."""
    n = a.shape[1]
    idx = jnp.arange(rows, dtype=jnp.float32)
    sent = jnp.where(idx >= n, sign * _SENTINEL * (1.0 + idx), 0.0)
    return jnp.pad(a.astype(jnp.float32), ((0, 0), (0, rows - n))) + sent


# log1p(u) = u * g(u) on [0, 1], with g a degree-8 polynomial fitted to
# log1p(u) / u (relative error ~3e-7 in f32, exact 0 at u = 0): nine FMAs in
# place of libdevice's log1pf in the softplus tail
_U = np.linspace(1e-12, 1.0, 20001)
_G = np.polynomial.chebyshev.Chebyshev.fit(_U, np.log1p(_U) / _U, deg=8)
_G = _G.convert(kind=np.polynomial.Polynomial).coef.astype(np.float32)
_LOG2E = float(np.log2(np.e))


def _log1p_poly(u):
    acc = jnp.float32(_G[-1])
    for c in _G[-2::-1]:
        acc = acc * u + jnp.float32(c)
    return u * acc


def _forces_kernel(x_ref, y_ref, fx_ref, fy_ref, *, tr, tc, nc, invk, k, cf, dmin, eps2):
    r = pl.program_id(1)
    rows = r * tr + jnp.arange(tr)
    xi = x_ref[pl.ds(r * tr, tr)][:, None]
    yi = y_ref[pl.ds(r * tr, tr)][:, None]

    def body(j, acc):
        fx, fy = acc
        cols = j * tc + jnp.arange(tc)
        dx = xi - x_ref[pl.ds(j * tc, tc)][None, :]
        dy = yi - y_ref[pl.ds(j * tc, tc)][None, :]
        d2 = dx * dx + dy * dy
        # 1 / max(dist, eps) and dist from one rsqrt; with eps = 0 a
        # coincident pair gives 0 * inf = NaN, as the XLA path does
        rinv = jax.lax.rsqrt(jnp.maximum(d2, eps2))
        z = (dmin - d2 * rinv) * invk
        # softplus(z) = max(z, 0) + log1p(exp(-|z|))
        u = jnp.exp2(-jnp.abs(z) * _LOG2E)
        pen = (jnp.maximum(z, 0.0) + _log1p_poly(u)) * k
        coef = (cf * pen) * rinv
        # the self pair is the only zero-distance pair that must not count
        coef = jnp.where(rows[:, None] != cols[None, :], coef, 0.0)
        return fx + coef * dx, fy + coef * dy

    zero = jnp.zeros((tr, tc), jnp.float32)
    fx, fy = jax.lax.fori_loop(0, nc, body, (zero, zero))
    fx_ref[...] = jnp.sum(fx, axis=1)
    fy_ref[...] = jnp.sum(fy, axis=1)


def collision_forces_pairwise(
    pos: Array, cfg: WorldCfg, *, interpret: bool = False, **config
) -> Array:
    """Soft-contact forces for a batch of worlds: pos [B, E, 2] -> [B, E, 2].

    ``cfg`` must satisfy :func:`sym_applicable`.  ``config`` overrides
    entries of :data:`FORCES_CONFIG`."""
    if not sym_applicable(cfg):
        raise ValueError(
            "the pairwise force kernel needs uniform size and mass with every "
            "entity colliding and movable"
        )
    config = {**FORCES_CONFIG, **config}
    B, E, _ = pos.shape
    rows = padded_rows(E)
    tr, tc = min(config["tile_rows"], rows), min(config["tile_cols"], rows)
    x = _pad(pos[..., 0], rows, 1.0)
    y = _pad(pos[..., 1], rows, 1.0)
    kernel = functools.partial(
        _forces_kernel,
        tr=tr,
        tc=tc,
        nc=rows // tc,
        invk=float(1.0 / cfg.contact_margin),
        k=float(cfg.contact_margin),
        cf=float(cfg.contact_force),
        dmin=float(2.0 * cfg.size[0]),
        eps2=1e-24 if cfg.nan_guard else 0.0,
    )
    whole = pl.BlockSpec((None, rows), lambda b, r: (b, 0))
    tile = pl.BlockSpec((None, tr), lambda b, r: (b, r))
    fx, fy = pl.pallas_call(
        kernel,
        grid=(B, rows // tr),
        in_specs=[whole, whole],
        out_specs=[tile, tile],
        out_shape=[jax.ShapeDtypeStruct((B, rows), jnp.float32)] * 2,
        compiler_params=plgpu.CompilerParams(
            num_warps=config["num_warps"], num_stages=config["num_stages"]
        ),
        interpret=interpret,
        name="pair_forces",
    )(x, y)
    return jnp.stack([fx[:, :E], fy[:, :E]], axis=-1).astype(pos.dtype)


def _stats_kernel(
    ax_ref, ay_ref, cx_ref, cy_ref, sx_ref, sy_ref, ha_ref, hs_ref, cnt_ref,
    *, t, nt, n, thresh2,
):
    big = jnp.float32(3.0e38)

    def row_tile(r, acc):
        ha, hs = acc
        rows = r * t + jnp.arange(t)
        xi, yi = ax_ref[pl.ds(r * t, t)][:, None], ay_ref[pl.ds(r * t, t)][:, None]
        cxi, cyi = cx_ref[pl.ds(r * t, t)][:, None], cy_ref[pl.ds(r * t, t)][:, None]
        sxi, syi = sx_ref[pl.ds(r * t, t)][:, None], sy_ref[pl.ds(r * t, t)][:, None]

        # elementwise [t, t] accumulators; each is reduced once per row tile
        def col_tile(j, c):
            amin, smin, cnt = c
            cols = j * t + jnp.arange(t)
            sl = pl.ds(j * t, t)
            # agent rows against ideal-shape vertices
            dx = cxi - sx_ref[sl][None, :]
            dy = cyi - sy_ref[sl][None, :]
            amin = jnp.minimum(amin, dx * dx + dy * dy)
            # vertex rows against centred agents
            dx = cx_ref[sl][None, :] - sxi
            dy = cy_ref[sl][None, :] - syi
            smin = jnp.minimum(smin, dx * dx + dy * dy)
            # agent rows against the other agents, uncentred
            dx = xi - ax_ref[sl][None, :]
            dy = yi - ay_ref[sl][None, :]
            hit = (dx * dx + dy * dy < thresh2) & (rows[:, None] != cols[None, :])
            return amin, smin, cnt + hit.astype(jnp.float32)

        full = jnp.full((t, t), big, jnp.float32)
        amin, smin, cnt = jax.lax.fori_loop(
            0, nt, col_tile, (full, full, jnp.zeros((t, t), jnp.float32))
        )
        cnt_ref[pl.ds(r * t, t)] = jnp.sum(cnt, axis=1)
        real = rows < n
        ha = jnp.maximum(ha, jnp.max(jnp.where(real, jnp.min(amin, axis=1), 0.0)))
        hs = jnp.maximum(hs, jnp.max(jnp.where(real, jnp.min(smin, axis=1), 0.0)))
        return ha, hs

    ha, hs = jax.lax.fori_loop(0, nt, row_tile, (jnp.float32(0.0), jnp.float32(0.0)))
    ha_ref[...] = ha
    hs_ref[...] = hs


def hd_stats_pairwise(
    apos: Array, ishape: Array, *, thresh: float, interpret: bool = False, **config
):
    """(hausdorff [B], per-agent collision count [B, N]) for the hd reward.

    ``apos`` [B, N, 2] raw agent positions, ``ishape`` [B, N, 2] the centred
    ideal shape, ``thresh`` the uniform collision distance.  ``config``
    overrides entries of :data:`STATS_CONFIG`."""
    config = {**STATS_CONFIG, **config}
    B, N, _ = apos.shape
    rows = padded_rows(N)
    t = min(config["tile"], rows)
    capos = apos - jnp.mean(apos, axis=1, keepdims=True)
    # agents and their centred copies sit at +sentinels, vertices at
    # -sentinels: a padded row is never any real row's minimum
    args = [
        _pad(apos[..., 0], rows, 1.0),
        _pad(apos[..., 1], rows, 1.0),
        _pad(capos[..., 0], rows, 1.0),
        _pad(capos[..., 1], rows, 1.0),
        _pad(ishape[..., 0], rows, -1.0),
        _pad(ishape[..., 1], rows, -1.0),
    ]
    whole = pl.BlockSpec((None, rows), lambda b: (b, 0))
    scalar = pl.BlockSpec((None,), lambda b: (b,))
    ha, hs, cnt = pl.pallas_call(
        functools.partial(
            _stats_kernel, t=t, nt=rows // t, n=N, thresh2=float(thresh) ** 2
        ),
        grid=(B,),
        in_specs=[whole] * 6,
        out_specs=[scalar, scalar, whole],
        out_shape=[
            jax.ShapeDtypeStruct((B,), jnp.float32),
            jax.ShapeDtypeStruct((B,), jnp.float32),
            jax.ShapeDtypeStruct((B, rows), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(
            num_warps=config["num_warps"], num_stages=config["num_stages"]
        ),
        interpret=interpret,
        name="hd_stats",
    )(*args)
    haus = jnp.sqrt(jnp.maximum(ha, hs)).astype(apos.dtype)
    return haus, cnt[:, :N].astype(apos.dtype)
