#!/usr/bin/env python
"""Time the GPU pair kernels (ops/gpu/pairwise.py) against XLA's plain path.

For each agent count: the force and reward-statistics kernels alone against
their vmapped XLA versions (with ``--sweep``, over tile sizes and warp
counts), then the hd ``bfs_state`` rollout end to end with the fastest
configs, kernels off, on, on, off.  Needs a GPU.

    python tools/pairwise_ab.py --num-agents 27 243 --num-envs 4096 [--sweep]

Prints one JSON line per measurement; ``--out FILE`` also writes them all.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gym_formation_tpu as ft  # noqa: E402
from gym_formation_tpu.core import physics  # noqa: E402
from gym_formation_tpu.ops import dispatch  # noqa: E402
from gym_formation_tpu.ops.gpu import pairwise  # noqa: E402
from gym_formation_tpu.utils import enable_compilation_cache  # noqa: E402

ROWS = []


def emit(**kw):
    ROWS.append(kw)
    print(json.dumps(kw), flush=True)


def timed(fn, *args, reps=20):
    """(compile+first call seconds, median seconds per call)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts))


def isolated(n, B, sweep):
    """Each kernel alone against its vmapped XLA version; returns the
    fastest force and stats configs."""
    env = ft.make_env("formation_hd_env", num_agents=n)
    cfg = physics._collide_subset(env.cfg)[3]
    st = jax.jit(jax.vmap(lambda k: env.reset(k)[0]))(
        jax.random.split(jax.random.PRNGKey(0), B)
    )
    apos, ishape = st.pos[:, :n], st.ideal_shape
    thresh = float(2.0 * cfg.size[0] * env.scenario.collision_factor)

    xla_forces = jax.jit(jax.vmap(lambda q: physics._collision_forces_xla(q, cfg)))
    ref_f = xla_forces(apos)
    scale = float(jnp.abs(ref_f).max())
    _, t = timed(xla_forces, apos)
    emit(what="forces", impl="xla", n=n, B=B, ms=t * 1e3)
    configs = [pairwise.FORCES_CONFIG]
    if sweep:
        configs += [dict(tile_rows=r, tile_cols=c, num_warps=w, num_stages=1)
                    for r, c, w in ((32, 32, 4), (16, 32, 1), (16, 64, 2),
                                    (32, 64, 4), (64, 32, 4), (64, 64, 4),
                                    (64, 64, 8))]
    best_f = None
    for c in configs:
        f = jax.jit(lambda p: pairwise.collision_forces_pairwise(p, cfg, **c))
        first, t = timed(f, apos)
        err = float(jnp.abs(f(apos) - ref_f).max()) / scale
        emit(what="forces", impl="kernel", config=c, n=n, B=B, ms=t * 1e3,
             compile_s=first, rel_err=err)
        if best_f is None or t < best_f[0]:
            best_f = (t, c)

    xla_stats = jax.jit(jax.vmap(env.scenario._hd_stats_xla))
    h_ref, c_ref = xla_stats(apos, ishape)
    _, t = timed(xla_stats, apos, ishape)
    emit(what="stats", impl="xla", n=n, B=B, ms=t * 1e3)
    configs = [pairwise.STATS_CONFIG]
    if sweep:
        configs += [dict(tile=tl, num_warps=w, num_stages=1)
                    for tl, w in ((16, 1), (32, 4), (64, 4), (64, 8))]
    best_s = None
    for c in configs:
        f = jax.jit(lambda a, s: pairwise.hd_stats_pairwise(a, s, thresh=thresh, **c))
        first, t = timed(f, apos, ishape)
        h, cnt = f(apos, ishape)
        emit(what="stats", impl="kernel", config=c, n=n, B=B, ms=t * 1e3,
             compile_s=first, haus_err=float(jnp.abs(h - h_ref).max()),
             count_diff=float(jnp.abs(cnt - c_ref).sum()))
        if best_s is None or t < best_s[0]:
            best_s = (t, c)
    return best_f[1], best_s[1]


def rollout(n, B, T, chunks, mode):
    """env-steps/s of the bfs_state rollout (bench.py's N=243 body)."""
    dispatch.set_kernel_mode(mode)
    env = ft.make_env("formation_hd_env", num_agents=n)

    def policy(state, key):
        # the 27- and 243-agent hierarchies are ternary
        return ft.bfs_actions_from_state(ft.ezpolicy_batched, env.scenario, state, 3)

    @jax.jit
    def chunk(state, key):
        keys = jax.random.split(key, B)
        state, rsum = jax.vmap(
            lambda s, k: ft.rollout_statepolicy_rewardsum(env, policy, s, k, T)
        )(state, keys)
        return state, rsum.sum()

    state = jax.jit(jax.vmap(lambda k: env.reset(k)[0]))(
        jax.random.split(jax.random.PRNGKey(0), B)
    )
    t0 = time.perf_counter()
    state, r = chunk(state, jax.random.PRNGKey(1))
    r.block_until_ready()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(chunks):
        state, r = chunk(state, jax.random.PRNGKey(2 + i))
    rv = float(r)
    dt = time.perf_counter() - t0
    emit(what="rollout", mode=mode, n=n, B=B, T=T,
         forces_config=pairwise.FORCES_CONFIG, stats_config=pairwise.STATS_CONFIG,
         env_steps_per_s=chunks * B * T / dt, compile_s=first,
         reward_finite=bool(np.isfinite(rv)))
    dispatch.set_kernel_mode("auto")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--num-agents", type=int, nargs="+", default=[27, 243])
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--chunks", type=int, default=8)
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("pairwise_ab.py needs a GPU")
    enable_compilation_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    emit(what="device", nvidia_smi=smi, kind=jax.devices()[0].device_kind)
    for n in args.num_agents:
        best_f, best_s = isolated(n, args.num_envs, args.sweep)
        pairwise.FORCES_CONFIG.update(best_f)
        pairwise.STATS_CONFIG.update(best_s)
        # parent, change, change, parent: the spread shows in the repeats
        for mode in ("off", "on", "on", "off"):
            rollout(n, args.num_envs, args.chunk, args.chunks, mode)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for row in ROWS:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
