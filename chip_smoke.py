#!/usr/bin/env python
"""Prove that the main path runs on an NVIDIA GPU, in one process.

    python chip_smoke.py                # one card: phases a-d
    python chip_smoke.py --four-cards   # four cards: phases a and e only

a. The device: the card's name and power limit (``nvidia-smi``) and JAX's
   device kind.  Exits non-zero when JAX finds no GPU.
b. The pairwise GPU kernels (ops/gpu/pairwise.py) against the plain XLA path
   at the N=243 collide subset, 4096 envs: forces, Hausdorff and collision
   counts, and both times.
c. The three bench.py SUITE rollouts through ``bench.run``, each also
   stepped 5 steps against the same seed with the kernels off at
   ``highest`` matmul precision.
d. MAPPO at N=3 (1024 envs, rollout_len 25, 10 epochs) and at N=243 with
   structured observations (1024 envs): two train steps each, and the
   structured first layer against ``obs @ W``.
e. (``--four-cards``) The N=243 ``bfs_state`` rollout at 8192 envs sharded
   2048 per card against the same envs on one card, and one MAPPO N=243
   train step under a 4-card mesh against the one-card step.

Every comparison states its tolerance and why.  A failed phase raises, so
the script exits non-zero; the last line of a run that passes is one JSON
object, ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HIGHEST = "highest"


def log(**kw):
    print(json.dumps(kw), flush=True)


def check(name, value, limit, why):
    """Log one comparison and fail the run when ``value > limit``."""
    ok = bool(value <= limit)
    log(check=name, value=float(value), limit=limit, why=why, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: {value} > {limit} ({why})")


def timed(fn, *args, reps=10):
    """Median seconds of ``fn(*args)`` after one warm-up call."""
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_pairwise(B=4096, n=243, interpret=False, time_it=True):
    """b: kernels against XLA at the N=243 collide subset."""
    import jax
    import jax.numpy as jnp

    import gym_formation_tpu as ft
    from gym_formation_tpu.core import physics
    from gym_formation_tpu.ops.gpu.pairwise import (
        collision_forces_pairwise,
        hd_stats_pairwise,
    )

    env = ft.make_env("formation_hd_env", num_agents=n)
    cfg = physics._collide_subset(env.cfg)[3]
    st = jax.jit(jax.vmap(lambda k: env.reset(k)[0]))(
        jax.random.split(jax.random.PRNGKey(0), B)
    )
    apos, ishape = st.pos[:, :n], st.ideal_shape
    # contact and deep-penetration pairs in every env
    apos = apos.at[:, 1].set(apos[:, 0] + jnp.asarray([0.04, 0.0], jnp.float32))
    apos = apos.at[:, 2].set(apos[:, 0] + jnp.asarray([0.0, 0.0301], jnp.float32))
    thresh = float(2.0 * cfg.size[0] * env.scenario.collision_factor)

    kern_f = jax.jit(lambda p: collision_forces_pairwise(p, cfg, interpret=interpret))
    xla_f = jax.jit(jax.vmap(lambda q: physics._collision_forces_xla(q, cfg)))
    kern_s = jax.jit(lambda a, s: hd_stats_pairwise(a, s, thresh=thresh, interpret=interpret))
    xla_s = jax.jit(jax.vmap(env.scenario._hd_stats_xla))

    f = kern_f(apos)
    h, c = kern_s(apos, ishape)
    with jax.default_matmul_precision(HIGHEST):
        f_ref = xla_f(apos)
        h_ref, c_ref = xla_s(apos, ishape)
    scale = float(jnp.abs(f_ref).max())
    check(
        "forces max abs err / max|F|",
        float(jnp.abs(f - f_ref).max()) / scale, 1e-4,
        "f32 sums of up to 255 terms in another order, with rsqrt, exp2 and "
        "a log1p polynomial good to ~3e-7 relative",
    )
    check(
        "hausdorff max abs err", float(jnp.abs(h - h_ref).max()), 1e-5,
        "the same squared distances up to FMA contraction; sqrt is monotone",
    )
    check(
        "collision count mismatches", float(jnp.abs(c - c_ref).sum()), 4.0,
        "d^2 < t^2 against d < t can differ only for a pair within one ulp "
        "of the threshold (expected well under one such pair here)",
    )
    if time_it:
        with jax.default_matmul_precision(HIGHEST):
            t_xla_f, t_xla_s = timed(xla_f, apos), timed(xla_s, apos, ishape)
        log(
            phase="pairwise", n=n, B=B,
            forces_kernel_ms=timed(kern_f, apos) * 1e3,
            forces_xla_ms=t_xla_f * 1e3,
            stats_kernel_ms=timed(kern_s, apos, ishape) * 1e3,
            stats_xla_ms=t_xla_s * 1e3,
        )


def _suite_args(overrides, **kw):
    import bench

    a = bench.build_parser().parse_args([])
    for k, v in {**overrides, **kw}.items():
        setattr(a, k, v)
    return a


def compare_steps(args, steps=5):
    """Step one configuration ``steps`` times with the kernels in auto mode
    and with them off at ``highest``, from the same seed.  Returns the
    largest position difference after the first step and after the last,
    the largest difference of the batch-mean reward relative to its size,
    and the largest share of envs whose own reward differs by more than
    1e-4 of its size."""
    import jax
    import numpy as np

    import bench
    from gym_formation_tpu.ops import dispatch

    def trajectory(mode, precision):
        dispatch.set_kernel_mode(mode)
        try:
            with jax.default_matmul_precision(precision):
                _, reset, run_chunk = bench.build(args, 1)
                state, obs = reset(jax.random.PRNGKey(0))
                out = []
                for t in range(steps):
                    state, obs, r = run_chunk(state, obs, jax.random.PRNGKey(1 + t))
                    out.append((np.asarray(state.pos), np.asarray(r)))
                return out
        finally:
            dispatch.set_kernel_mode("auto")

    a, b = trajectory("auto", "default"), trajectory("off", HIGHEST)
    dpos = [float(np.abs(pa - pb).max()) for (pa, _), (pb, _) in zip(a, b)]
    dmean, shares = [], []
    for (_, ra), (_, rb) in zip(a, b):
        scale = np.maximum(np.abs(rb), 1.0)
        dmean.append(abs(ra.mean() - rb.mean()) / max(abs(rb.mean()), 1.0))
        shares.append(float(np.mean(np.abs(ra - rb) > 1e-4 * scale)))
    return dpos[0], dpos[-1], max(dmean), max(shares)


def phase_rollouts(num_envs=4096, chunk=64, iters=4, agents_243=243):
    """c: the three SUITE rollouts through bench.run."""
    import bench
    from gym_formation_tpu.utils.device import nvidia_smi_line

    for overrides in bench.SUITE:
        overrides = dict(overrides)
        if overrides.get("num_agents") == 243:
            overrides["num_agents"] = agents_243
        args = _suite_args(overrides, num_envs=num_envs, chunk=chunk, iters=iters, windows=1)
        row = bench.run(args)
        if not math.isfinite(row["reward_sum"]):
            raise AssertionError(f"non-finite reward sum: {row}")
        log(phase="rollout", config=row["metric"], env_steps_per_s=row["value"],
            card=nvidia_smi_line(), compile_s=row["compile_s"])
        dpos1, dpos, dmean, share = compare_steps(args)
        name = row["metric"]
        check(
            f"{name}: position diff after 1 step vs kernels off at highest",
            dpos1, 1e-5,
            "one step of f32 force sums in another order, times dt^2",
        )
        check(
            f"{name}: position diff after 5 steps", dpos, 1e-3,
            "contact stiffness (force over a 1e-3 margin) amplifies f32 "
            "differences each step; the paths part after about 10 steps",
        )
        check(
            f"{name}: batch-mean reward diff / |mean reward|, any of 5 steps",
            dmean, 1e-4,
            "the continuous reward terms agree to f32; collision flips of "
            "borderline pairs average out over the batch",
        )
        check(
            f"{name}: share of envs whose reward differs by > 1e-4", share, 0.05,
            "an env's collision count is discrete: a pair at the threshold "
            "can flip and move that env's reward by 2N, about 1% at N=243",
        )


def _mappo(n, num_envs, **cfg):
    import gym_formation_tpu as ft
    from gym_formation_tpu.algos.mappo import MAPPO, MAPPOConfig

    env = ft.make_env("formation_hd_env", num_agents=n)
    return MAPPO(env, MAPPOConfig(**cfg), num_envs=num_envs)


def phase_mappo(num_envs=1024, n_big=243, rollout_len=25, ppo_epochs=10):
    """d: two MAPPO train steps at N=3 and at N=243 (structured)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import gym_formation_tpu as ft
    from gym_formation_tpu.models.structured_obs import hd_actor_h1

    for n in (3, n_big):
        algo = _mappo(n, num_envs, rollout_len=rollout_len, ppo_epochs=ppo_epochs)
        ts, es, obs = algo.init(jax.random.PRNGKey(0))
        t0 = time.perf_counter()
        ts, es, obs, m = algo.train_step(ts, es, obs, jax.random.PRNGKey(1))
        jax.block_until_ready(m)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ts, es, obs, m = algo.train_step(ts, es, obs, jax.random.PRNGKey(2))
        m = {k: float(v) for k, v in m.items()}
        step_s = time.perf_counter() - t0
        for k in ("v_loss", "pg_loss"):
            if not math.isfinite(m[k]):
                raise AssertionError(f"MAPPO N={n}: non-finite {k}: {m}")
        print(f"MAPPO N={n} compile seconds: {first_s - step_s:.1f}", flush=True)
        log(phase="mappo", n=n, num_envs=num_envs, structured=algo.structured_obs,
            first_step_s=first_s, second_step_s=step_s, metrics=m)

        if algo.structured_obs:
            env = ft.make_env("formation_hd_env", num_agents=n)
            st, o = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(3), 64))
            p = ts.params["actor"]["params"]["MLP_0"]["Dense_0"]
            with jax.default_matmul_precision(HIGHEST):
                h1 = jax.jit(hd_actor_h1)(
                    p["kernel"], p["bias"], st.pos[:, :n], st.vel[:, :n],
                    st.ideal_shape, st.ideal_vel,
                )
                ref = jnp.asarray(o) @ p["kernel"] + p["bias"]
            check(
                "structured h1 vs obs @ W, max abs err",
                float(np.abs(np.asarray(h1 - ref)).max()), 1e-4,
                "exact linear algebra up to f32 reassociation of ~6N-term "
                "sums of O(1) products; 2e-5 on the CPU",
            )


def phase_four_cards(num_envs=8192, steps=5, n=243, mappo_envs=1024, rollout_len=25):
    """e: the sharded N=243 rollout and MAPPO step against one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from gym_formation_tpu.parallel import parse_mesh_arg, shard_train_tuple

    cards = 4
    if len(jax.devices()) < cards:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(jax.devices())}")
    args = _suite_args({"num_agents": n, "policy": "bfs_state"}, num_envs=num_envs)

    def run(mesh):
        args.mesh = mesh
        _, reset, run_chunk = bench.build(args, steps)
        state, obs = reset(jax.random.PRNGKey(0))
        t0 = time.perf_counter()
        state, _, r = run_chunk(state, obs, jax.random.PRNGKey(1))
        jax.block_until_ready(r)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(run_chunk(state, obs, jax.random.PRNGKey(2)))
        log(phase="four_cards_rollout", mesh=mesh, num_envs=num_envs, steps=steps,
            compile_s=first, env_steps_per_s=num_envs * steps / (time.perf_counter() - t0))
        return np.asarray(state.pos), np.asarray(r)

    pos4, r4 = run(cards)
    pos1, r1 = run(None)
    per = num_envs // cards
    for s in range(cards):
        sl = slice(s * per, (s + 1) * per)
        check(
            f"rollout shard {s}: position diff vs one card",
            float(np.abs(pos4[sl] - pos1[sl]).max()), 1e-5,
            "each env runs the same per-env program; only XLA's fusion of "
            "the batched ops may differ with the batch size",
        )
        check(
            f"rollout shard {s}: reward diff / |reward| vs one card",
            float(np.abs(r4[sl] - r1[sl]).max() / max(np.abs(r1[sl]).max(), 1.0)), 1e-5,
            "as for positions",
        )

    def mappo_step(mesh_spec):
        algo = _mappo(n, mappo_envs, rollout_len=rollout_len, ppo_epochs=1)
        state = list(algo.init(jax.random.PRNGKey(0)))
        if mesh_spec:
            state = shard_train_tuple("mappo", state, parse_mesh_arg(mesh_spec))
        t0 = time.perf_counter()
        *_, m = algo.train_step(*state, jax.random.PRNGKey(1))
        m = {k: float(v) for k, v in m.items()}
        log(phase="four_cards_mappo", mesh=mesh_spec, compile_and_step_s=time.perf_counter() - t0,
            metrics=m)
        return m

    m4, m1 = mappo_step(str(cards)), mappo_step(None)
    for k in ("mean_step_reward", "v_loss", "pg_loss", "entropy"):
        if not math.isfinite(m4[k]):
            raise AssertionError(f"mesh MAPPO: non-finite {k}")
        check(
            f"mappo {k}: 4-card mesh vs one card",
            abs(m4[k] - m1[k]) / max(abs(m1[k]), 1e-2), 2e-3,
            "the gradient all-reduce sums in another order and the actor "
            "runs at the default (TF32) precision on both",
        )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-card mesh phase (needs 4 GPUs)")
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})", file=sys.stderr)
        return 1
    from gym_formation_tpu.utils import enable_compilation_cache
    from gym_formation_tpu.utils.device import nvidia_smi_line

    smi = nvidia_smi_line()
    print(f"nvidia-smi: {smi}", flush=True)
    log(phase="device", kind=dev.device_kind, count=len(jax.devices()), nvidia_smi=smi)
    enable_compilation_cache()
    if args.four_cards:
        phases = [phase_four_cards]
        count = 4
    else:
        phases = [phase_pairwise, phase_rollouts, phase_mappo]
        count = 1
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        log(phase=phase.__name__, seconds=time.perf_counter() - t0, passed=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
