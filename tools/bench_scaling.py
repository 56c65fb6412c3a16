#!/usr/bin/env python
"""Weak-scaling efficiency harness: env-steps/s vs mesh size.

Fixes a per-device env count and sweeps data-parallel mesh sizes 1..D,
reporting throughput and efficiency vs the 1-device run.  On real hardware
the mesh spans devices and hosts; in CI it runs on virtual CPU devices
(``--force-cpu-devices N``) to validate the mechanism (the reference has no
multi-node test story at all — SURVEY §4/§5).

Two workloads:
- ``rollout`` (default): pure env stepping — zero cross-device traffic, the
  embarrassingly-parallel axis;
- ``train``: the full MAPPO train_step (rollout scan + GAE + PPO epochs) —
  the program whose gradient reduction actually exercises mesh collectives.

    python tools/bench_scaling.py --force-cpu-devices 8 --envs-per-device 64
    python tools/bench_scaling.py --workload train --force-cpu-devices 8 \\
        --envs-per-device 64
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scenario", default="formation_hd_env")
    p.add_argument("--num-agents", type=int, default=3)
    p.add_argument("--envs-per-device", type=int, default=512)
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--force-cpu-devices", type=int, default=0)
    p.add_argument(
        "--workload", choices=["rollout", "train"], default="rollout",
        help="rollout: vmapped env scan (no collectives); train: full MAPPO "
        "train_step incl. gradient reduction over the mesh",
    )
    p.add_argument(
        "--tp", type=int, default=1,
        help="tensor-parallel factor for --workload train (mesh is "
        "(devices/tp) x tp)",
    )
    args = p.parse_args()

    if args.force_cpu_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.force_cpu_devices}"
        )
    import jax

    if args.force_cpu_devices:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import gym_formation_tpu as ft
    from gym_formation_tpu.parallel import make_mesh, shard_batch

    env = ft.make_env(args.scenario, num_agents=args.num_agents)

    def policy(obs, key):
        return jax.random.uniform(
            key, obs.shape[:-1] + (env.act_dim,), jnp.float32, -1.0, 1.0
        )

    def rollout_throughput(n_dev: int) -> float:
        B = args.envs_per_device * n_dev
        mesh = make_mesh(devices=jax.devices()[:n_dev])

        @jax.jit
        def run_chunk(state, obs, key):
            keys = jax.random.split(key, B)
            (state, obs), outs = jax.vmap(
                lambda s, o, k: ft.rollout(env, policy, s, o, k, args.chunk)
            )(state, obs, keys)
            return state, obs, outs.reward.sum()

        state, obs = jax.jit(jax.vmap(env.reset))(
            jax.random.split(jax.random.PRNGKey(0), B)
        )
        state = shard_batch(state, mesh)
        obs = shard_batch(obs, mesh)
        state, obs, r = run_chunk(state, obs, jax.random.PRNGKey(1))
        float(jax.device_get(r))  # value fetch: proves execution (see bench.py)
        t0 = time.perf_counter()
        for i in range(args.iters):
            state, obs, r = run_chunk(state, obs, jax.random.PRNGKey(2 + i))
        float(jax.device_get(r))
        return B * args.chunk * args.iters / (time.perf_counter() - t0)

    def train_throughput(n_dev: int) -> float:
        """Full MAPPO train_step env-steps/s on a (n_dev/tp) x tp mesh."""
        from gym_formation_tpu.algos.registry import make_algo
        from gym_formation_tpu.parallel import parse_mesh_arg, shard_train_tuple

        tp = args.tp if n_dev % max(args.tp, 1) == 0 and n_dev >= args.tp else 1
        dp = n_dev // tp
        B = args.envs_per_device * dp
        mesh = parse_mesh_arg(f"{dp},{tp}", devices=jax.devices()[:n_dev])
        algo = make_algo("mappo", env, num_envs=B)
        state = shard_train_tuple(
            "mappo", list(algo.init(jax.random.PRNGKey(0))), mesh
        )
        *state, m = algo.train_step(*state, jax.random.PRNGKey(1))
        jax.device_get(m)  # value fetch: proves execution (see bench.py)
        t0 = time.perf_counter()
        for i in range(args.iters):
            *state, m = algo.train_step(*state, jax.random.PRNGKey(2 + i))
        jax.device_get(m)
        steps = B * algo.cfg.rollout_len * args.iters
        return steps / (time.perf_counter() - t0)

    throughput = (
        train_throughput if args.workload == "train" else rollout_throughput
    )

    n_devices = len(jax.devices())
    sweep = sorted({1, 2, n_devices // 2, n_devices} - {0})
    results = []
    base = None
    for d in sweep:
        if d > n_devices:
            continue
        rate = throughput(d)
        if base is None:
            base = rate
        eff = rate / (base * d)
        results.append(
            {"devices": d, "steps_per_s": round(rate, 1), "efficiency": round(eff, 3)}
        )
        print(json.dumps(results[-1]))
    print(
        json.dumps(
            {
                "metric": (
                    f"weak-scaling efficiency ({args.workload}) at "
                    f"{n_devices} devices"
                ),
                "value": results[-1]["efficiency"],
                "unit": "fraction",
                "sweep": results,
            }
        )
    )


if __name__ == "__main__":
    main()
