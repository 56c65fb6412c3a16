#!/usr/bin/env python
"""Rollout benchmark: env-steps/s at 4096 parallel envs.

Runs a scenario with a scripted policy through a jitted ``lax.scan`` of the
full env step (physics + obs + reward + done + auto-reset), vmapped over the
env batch on the default device, or sharded over ``--mesh`` devices.  Prints
one JSON line per configuration:

    {"metric": ..., "value": N, "unit": "env-steps/s", "device": {...}, ...}

``device`` names the platform, the device kind and count, and on a GPU the
card's ``nvidia-smi`` name and power limit.  With no arguments it runs the
SUITE of configurations below.
"""

import argparse
import json
import math
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, __file__.rsplit("/", 1)[0])

import gym_formation_tpu as ft  # noqa: E402
from gym_formation_tpu.ops import dispatch  # noqa: E402
from gym_formation_tpu.utils import enable_compilation_cache  # noqa: E402
from gym_formation_tpu.utils.device import describe_device  # noqa: E402

enable_compilation_cache()


def emit(metric, window_rates):
    """One JSON line: median of the in-process timed windows as the headline,
    min/max as the spread, and the device the windows ran on."""
    med = statistics.median(window_rates)
    row = {
        "metric": metric,
        "value": med,
        "unit": "env-steps/s",
        "windows": len(window_rates),
        "min": min(window_rates),
        "max": max(window_rates),
        "device": describe_device(),
    }
    print(json.dumps(row), flush=True)
    return row


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--scenario", default="formation_hd_env")
    p.add_argument("--num-agents", type=int, default=3)
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--chunk", type=int, default=256, help="scan steps per device call")
    p.add_argument("--iters", type=int, default=16)
    p.add_argument(
        "--windows", type=int, default=3,
        help="timed windows per run; the JSON reports their median as "
        "`value` plus min/max",
    )
    p.add_argument(
        "--pallas", choices=list(dispatch.MODES), default="auto",
        help="GPU pair kernels (ops/gpu/pairwise.py): auto picks them on a "
        "GPU for large worlds, on forces them (and fails off a GPU), off "
        "runs plain XLA",
    )
    p.add_argument(
        "--mesh", type=int, default=None, metavar="DP",
        help="shard the env batch data-parallel over DP devices (rollouts "
        "have zero cross-device traffic, so this is the weak-scaling axis); "
        "default: single default device",
    )
    p.add_argument(
        "--policy",
        choices=["ezpolicy", "random", "bfs", "bfs_state", "linear"],
        default="ezpolicy",
        help="ezpolicy (default): scripted policy consuming the observations "
        "- the honest end-to-end pipeline (with a random policy XLA "
        "dead-code-eliminates obs construction); bfs: hierarchical expansion; "
        "bfs_state: the same hierarchical controller fed O(N) state "
        "quantities directly (rollout_statepolicy) - same actions, no "
        "[N, 6N] obs tensor; linear: clip(obs @ W, -1, 1) with a fixed "
        "random W - a generic obs consumer for scenarios whose observation "
        "layout ezpolicy cannot parse (hd_obs/partial/partial_range), so "
        "their bench rows still time the full obs pipeline",
    )
    return p


def make_policy(args, env):
    """``policy(obs_or_state, key) -> actions`` for ``args.policy``."""
    if args.policy == "ezpolicy":
        return lambda obs, key: ft.ezpolicy_batched(obs)
    if args.policy in ("bfs", "bfs_state"):
        n_per_layer = args.num_agents
        # smallest n>=2 whose power equals num_agents (BFS arity)
        for cand in range(2, args.num_agents + 1):
            L = round(np.log(args.num_agents) / np.log(cand))
            if cand ** max(L, 1) == args.num_agents:
                n_per_layer = cand
                break
        if args.policy == "bfs_state":
            return lambda state, key: ft.bfs_actions_from_state(
                ft.ezpolicy_batched, env.scenario, state, n_per_layer
            )
        return lambda obs, key: ft.bfs_actions(ft.ezpolicy_batched, obs, n_per_layer)
    if args.policy == "linear":
        W_lin = jax.random.normal(
            jax.random.PRNGKey(7), (env.scenario.obs_dim, env.act_dim)
        ) * (1.0 / env.scenario.obs_dim ** 0.5)
        return lambda obs, key: jnp.clip(obs @ W_lin, -1.0, 1.0)
    return lambda obs, key: jax.random.uniform(
        key, obs.shape[:-1] + (env.act_dim,), jnp.float32, -1.0, 1.0
    )


def build(args, length):
    """``(env, reset, run_chunk)`` for one configuration.

    ``reset(key) -> (state, obs)`` draws the batch (``obs`` is None for
    ``bfs_state``, which never builds the [B, N, 6N] observation);
    ``run_chunk(state, obs, key) -> (state, obs, rewards [B])`` advances
    every env ``length`` steps and returns each env's reward sum.  With
    ``--mesh`` the batch is placed over the devices and the per-device body
    runs under ``shard_map``: GSPMD does not partition a Pallas kernel, and
    envs have no cross-env coupling, so each device steps its own slice."""
    env = ft.make_env(args.scenario, num_agents=args.num_agents)
    B = args.num_envs
    policy = make_policy(args, env)

    if args.policy == "bfs_state":

        def body(state, obs, keys):
            # reward-sum variant: a stacked [B, T, N] reward output is
            # 8.2 GB at the N=243 x 8192 x 256 config
            state, rsum = jax.vmap(
                lambda s, k: ft.rollout_statepolicy_rewardsum(env, policy, s, k, length)
            )(state, keys)
            return state, obs, rsum

        reset_one = lambda k: (env.reset(k)[0], None)
    else:

        def body(state, obs, keys):
            (state, obs), outs = jax.vmap(
                lambda s, o, k: ft.rollout(env, policy, s, o, k, length)
            )(state, obs, keys)
            return state, obs, outs.reward.sum(axis=(1, 2))

        reset_one = env.reset

    reset_b = jax.jit(jax.vmap(reset_one))
    place = lambda tree: tree
    if args.mesh:
        from jax.sharding import PartitionSpec as P

        from gym_formation_tpu.parallel import make_mesh, shard_batch

        assert B % args.mesh == 0, (B, args.mesh)
        mesh = make_mesh((args.mesh,), ("data",), devices=jax.devices()[: args.mesh])
        spec = (P("data"),) * 3
        # pallas_call results carry no varying-axis annotation; the body is
        # per-shard pure, so the check is skipped
        body = jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
        place = lambda tree: shard_batch(tree, mesh)

    def reset(key):
        return place(reset_b(jax.random.split(key, B)))

    @jax.jit
    def run_chunk(state, obs, key):
        return body(state, obs, jax.random.split(key, B))

    return env, reset, run_chunk


def run(args):
    """Time ``args.windows`` windows of ``args.iters`` chunks; print and
    return the JSON row, with the warm-up chunk's compile seconds."""
    dispatch.set_kernel_mode(args.pallas)
    try:
        _, reset, run_chunk = build(args, args.chunk)
        B, T = args.num_envs, args.chunk
        state, obs = reset(jax.random.PRNGKey(0))

        # warm-up and compile; every window ends in a host fetch of the
        # reward, which proves the chain ran and is checked finite
        t0 = time.perf_counter()
        state, obs, r = run_chunk(state, obs, jax.random.PRNGKey(1))
        rv = float(r.sum())
        compile_s = time.perf_counter() - t0
        assert math.isfinite(rv), f"non-finite reward from warmup chunk: {rv}"

        rates = []
        seed = 2
        for _ in range(args.windows):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                state, obs, r = run_chunk(state, obs, jax.random.PRNGKey(seed))
                seed += 1
            rv = float(r.sum())
            dt = time.perf_counter() - t0
            assert math.isfinite(rv), f"non-finite reward from timed run: {rv}"
            rates.append(args.iters * B * T / dt)
    finally:
        dispatch.set_kernel_mode("auto")
    row = emit(
        f"env-steps/s ({args.scenario}, N={args.num_agents}, {B} envs, "
        f"{args.policy} policy)",
        rates,
    )
    row.update(compile_s=compile_s, reward_sum=rv)
    return row


# The configurations the no-args invocation runs, in order: the N=3
# headline, the N=243 five-layer hierarchy, then basic_formation.
SUITE = (
    {},  # formation_hd_env N=3 ezpolicy (defaults)
    {"num_agents": 243, "policy": "bfs_state"},  # BFS from state, pair kernels
    {"scenario": "basic_formation_env"},  # ezpolicy
)


def main():
    p = build_parser()
    args = p.parse_args()
    if len(sys.argv) > 1:
        run(args)
        return
    for overrides in SUITE:
        a = argparse.Namespace(**vars(args))
        for k, v in overrides.items():
            setattr(a, k, v)
        run(a)


if __name__ == "__main__":
    main()
