#!/usr/bin/env python
"""Split-time the MAPPO train iteration: collection scan vs PPO update.

Measures where a training iteration's time goes before anything is fused.
Honest timing: pipelined windows closed by a host value fetch
of a run-dependent quantity, finiteness asserted.

Usage: python tools/bench_mappo_split.py [-n 3] [-B 1024] [--iters 32]
"""

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import gym_formation_tpu as ft
from gym_formation_tpu.algos import MAPPO, MAPPOConfig
from gym_formation_tpu.utils import enable_compilation_cache

enable_compilation_cache()


def timed(tag, fn, state, iters, fetch):
    out = fn(state)  # warmup/compile
    v = float(fetch(out))
    assert math.isfinite(v), (tag, v)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(out if isinstance(out, type(state)) else state)
    v = float(fetch(out))
    dt = time.perf_counter() - t0
    assert math.isfinite(v), (tag, v)
    print(f"{tag:>28}: {dt / iters * 1e3:8.2f} ms/iter", flush=True)
    return dt / iters


def _timeit(tag, fn, fetch, iters):
    out = fn()  # warmup/compile
    v = float(fetch(out))
    assert math.isfinite(v), (tag, v)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    v = float(fetch(out))
    dt = (time.perf_counter() - t0) / iters
    assert math.isfinite(v), (tag, v)
    print(f"{tag:>34}: {dt * 1e3:8.2f} ms/call", flush=True)
    return dt


def update_decomp(algo, ts, es, obs, key, iters):
    """Decompose the PPO update by deliberate DCE (the technique of
    tools/exp_step_decomp.py): each probe jits only a sub-pipeline of the
    epoch and fetches a checksum data-dependent on exactly that much."""
    cfg = algo.cfg
    collect_fn = algo._collect_structured if algo.structured_obs else algo._collect
    es, obs, traj, _, last_v = jax.jit(
        lambda es, obs: collect_fn(ts, es, obs, key)
    )(es, obs)

    prep = jax.jit(lambda tr, lv: algo._prepare(ts, tr, lv))
    ts2, data = prep(traj, last_v)
    vn = ts2.value_norm
    E = cfg.ppo_epochs
    M = cfg.rollout_len * algo.num_envs
    N, H, da = algo.n_agents, cfg.hidden[0], algo.act_dim

    print(
        f"update decomposition: N={N} B={algo.num_envs} "
        f"T={cfg.rollout_len} M={M} epochs={E} "
        f"structured={algo.structured_obs} grad_accum={cfg.grad_accum} "
        f"remat={cfg.remat}"
    )

    # -- probes, innermost first ------------------------------------------
    t_prep = _timeit(
        "prep (GAE+valuenorm+flatten)",
        lambda: prep(traj, last_v),
        lambda o: o[1]["target"].sum(),
        iters,
    )

    if algo.structured_obs:
        from gym_formation_tpu.models.structured_obs import (
            actor_forward_structured,
            critic_forward_structured,
        )

        def actor_dist(p, d):
            parts = (d["apos"], d["avel"], d["ishape"], d["ivel"])
            return actor_forward_structured(
                p["actor"], *parts, cfg.hidden,
                dtype=jnp.bfloat16 if cfg.structured_bf16 else None,
            )

        def critic_value(p, d):
            parts = (d["apos"], d["avel"], d["ishape"], d["ivel"])
            return critic_forward_structured(p["critic"], *parts, cfg.hidden)

    else:

        def actor_dist(p, d):
            return algo._apply_actor(p["actor"], d["obs"])

        def critic_value(p, d):
            so = d["obs"].reshape(d["obs"].shape[0], -1)
            return algo._apply_critic(p["critic"], so)

    def pg_term(p, d):
        dist = actor_dist(p, d)
        logp = algo._dist_logp(dist, d["action"])
        ratio = jnp.exp(jnp.clip(logp - d["logp"], -20.0, 20.0))
        adv = d["adv"]
        if adv.ndim == 1:
            adv = adv[:, None]
        pg1 = ratio * adv
        pg2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        return (
            -jnp.mean(jnp.minimum(pg1, pg2))
            - cfg.entropy_coef * algo._dist_entropy(dist)
        )

    def v_term(p, d):
        from gym_formation_tpu.algos.mappo import huber

        value = critic_value(p, d)
        v_old, target = d["value"], d["target"]
        v_clip = v_old + jnp.clip(value - v_old, -cfg.clip_eps, cfg.clip_eps)
        return cfg.value_coef * jnp.mean(
            jnp.maximum(
                huber(value - target, cfg.huber_delta),
                huber(v_clip - target, cfg.huber_delta),
            )
        )

    # every probe takes params/data as ARGUMENTS (closed-over arrays are jit
    # constants — XLA constant-folds through them and the probe times a
    # different program than the real update runs)
    p0 = ts2.params
    jit_pg = jax.jit(pg_term)
    t_afwd = _timeit(
        "actor fwd (pg loss value)", lambda: jit_pg(p0, data),
        lambda o: o, iters,
    )
    ga = jax.jit(jax.grad(pg_term))
    t_agrad = _timeit(
        "actor fwd+bwd (pg grad)", lambda: ga(p0, data),
        lambda o: o["actor"]["params"]["MLP_0"]["Dense_0"]["kernel"].sum(),
        iters,
    )
    jit_v = jax.jit(v_term)
    t_cfwd = _timeit(
        "critic fwd (v loss value)", lambda: jit_v(p0, data),
        lambda o: o, iters,
    )
    gc = jax.jit(jax.grad(v_term))
    t_cgrad = _timeit(
        "critic fwd+bwd (v grad)", lambda: gc(p0, data),
        lambda o: o["critic"]["params"]["MLP_0"]["Dense_0"]["kernel"].sum(),
        iters,
    )
    gfull = jax.jit(
        lambda p, d, v: jax.grad(algo._loss, has_aux=True)(p, d, v)[0]
    )
    t_grad = _timeit(
        "joint loss fwd+bwd (jax.grad)", lambda: gfull(p0, data, vn),
        lambda o: o["actor"]["params"]["MLP_0"]["Dense_0"]["kernel"].sum(),
        iters,
    )

    @jax.jit
    def one_epoch(p, d, v, opt_state):
        grads, _ = jax.grad(algo._loss, has_aux=True)(p, d, v)
        upd, opt_state = algo.tx.update(grads, opt_state, p)
        import optax as _optax

        return _optax.apply_updates(p, upd)

    t_epoch = _timeit(
        "epoch (grad + clip + adam)",
        lambda: one_epoch(p0, data, vn, ts2.opt_state),
        lambda o: o["actor"]["params"]["MLP_0"]["Dense_0"]["kernel"].sum(),
        iters,
    )
    upd_full = jax.jit(lambda t, d, k: algo._update(t, d, k))
    t_upd = _timeit(
        f"full update ({E} epochs)", lambda: upd_full(ts2, data, key),
        lambda o: o[1]["v_loss"], max(iters // 4, 2),
    )

    print(f"{'optimizer share (epoch-grad)':>34}: {(t_epoch - t_grad) * 1e3:8.2f} ms")
    print(f"{'E*epoch + prep (additive)':>34}: {(E * t_epoch + t_prep) * 1e3:8.2f} ms")
    print(f"{'full update measured':>34}: {t_upd * 1e3:8.2f} ms")

    if algo.structured_obs:
        L = len(cfg.hidden)
        a_fwd = (
            2 * (N - 1) * 2 * H  # d + tot slot einsums
            + N * (N - 1) * H  # triangle
            + 2 * N * 2 * H  # apos@U + avel@Wv
            + 2 * N * H + 2 * H  # ishape + ivel
            + (L - 1) * N * H * H  # MLP tail
            + N * H * da  # head
        )
        c_fwd = (
            3 * N * 2 * H + 2 * N * H + 2 * H + (L - 1) * H * H + H
        )
        c_pre = 2 * N * (N - 1) * 2 * H  # parameter-only V/U precompute
        macs_epoch = M * (3 * a_fwd + 3 * c_fwd) + 3 * c_pre
        tf = 2 * macs_epoch / 1e12
        print(
            f"{'analytic epoch MACs':>34}: {macs_epoch / 1e9:8.1f} G "
            f"({tf:.2f} TFLOP; fwd+bwd=3x fwd)"
        )
        print(
            f"{'implied f32 matmul rate':>34}: "
            f"{tf / t_epoch:8.1f} TFLOP/s over the epoch probe"
        )


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-n", "--num-agents", type=int, default=3)
    p.add_argument("-B", "--num-envs", type=int, default=1024)
    p.add_argument("--iters", type=int, default=32)
    p.add_argument("--decomp", action="store_true",
                   help="decompose the PPO update itself (GAE/prep, actor "
                   "fwd, actor fwd+bwd, critic fwd+bwd, optimizer) via "
                   "deliberate DCE")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="MAPPOConfig.structured_bf16: bf16 structured-actor "
                   "compute (flag-gated training-math change)")
    args = p.parse_args()

    env = ft.make_env("formation_hd_env", num_agents=args.num_agents)
    algo = MAPPO(
        env,
        MAPPOConfig(
            grad_accum=args.grad_accum, remat=args.remat,
            structured_bf16=args.bf16,
        ),
        num_envs=args.num_envs,
    )
    ts, es, obs = algo.init(jax.random.PRNGKey(0))

    key = jax.random.PRNGKey(1)

    if args.decomp:
        update_decomp(algo, ts, es, obs, key, args.iters)
        return

    # full train_step (chained through its own outputs; donate the carry —
    # without it the wrapper holds two generations of the [T·B, ...]
    # trajectory-scale buffers and OOMs at N=243 B>=1024)
    from functools import partial as _partial

    @_partial(jax.jit, donate_argnums=(0,))
    def full(carry):
        ts, es, obs = carry
        ts, es, obs, m = algo.train_step(ts, es, obs, key)
        return (ts, es, obs, m["v_loss"])

    o = full((ts, es, obs))  # donates the init tuple
    v = float(o[3])
    assert math.isfinite(v)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        o = full(o[:3])
    v = float(o[3])
    dt_full = (time.perf_counter() - t0) / args.iters
    assert math.isfinite(v)
    print(f"{'full train_step':>28}: {dt_full * 1e3:8.2f} ms/iter", flush=True)

    # collection only — fresh tuple (the full phase donated the first one);
    # mirror the path train_step actually resolved (structured_obs auto-on
    # at N>=32 replaces the obs-storing scan)
    ts, es, obs = algo.init(jax.random.PRNGKey(0))
    collect_fn = algo._collect_structured if algo.structured_obs else algo._collect

    @_partial(jax.jit, donate_argnums=(0,))
    def collect(carry):
        es, obs = carry
        es2, obs2, traj, bench, last_v = collect_fn(ts, es, obs, key)
        return (es2, obs2, traj["reward"].sum() + last_v.sum())

    r = collect((es, obs))  # donates the fresh tuple
    v = float(r[2])
    assert math.isfinite(v)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        r = collect((r[0], r[1]))
    v = float(r[2])
    dt_col = (time.perf_counter() - t0) / args.iters
    assert math.isfinite(v)
    print(f"{'collect scan only':>28}: {dt_col * 1e3:8.2f} ms/iter", flush=True)

    print(
        f"{'implied update+GAE':>28}: {(dt_full - dt_col) * 1e3:8.2f} ms/iter",
        flush=True,
    )


if __name__ == "__main__":
    main()
