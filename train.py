#!/usr/bin/env python
"""Training CLI — the consolidated replacement for the reference's trainer zoo
entry points (``train/maddpg-v1/main.py``, ``train/mappo/train_formation.py``,
``train/maddpg-v5/train.py``).

Examples:
    python train.py --algo mappo --scenario formation_hd_env --num-agents 3 \\
        --num-envs 128 --iters 500
    python train.py --algo maddpg --num-agents 3 --num-envs 32 --iters 200
    python train.py --algo rmappo --restore --run-dir runs/my_run
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

import gym_formation_tpu as ft
from gym_formation_tpu.algos.registry import (
    ALGO_NAMES,
    DISCRETE_ONLY,
    EPISODIC,
    ONPOLICY,
    make_algo,
)
from gym_formation_tpu.utils import (
    MetricsLogger,
    enable_compilation_cache,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

enable_compilation_cache()


def build(args, env):
    """Return (algo, cfg, state) where state is the full training tuple."""
    algo = make_algo(
        args.algo, env, num_envs=args.num_envs,
        sets=args.set or [], config_yaml=args.config, lr=args.lr,
    )
    return algo, algo.cfg, list(algo.init(jax.random.PRNGKey(args.seed)))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--algo", choices=list(ALGO_NAMES), default="mappo")
    p.add_argument("--scenario", default="formation_hd_env")
    p.add_argument("--num-agents", type=int, default=3)
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--iters", type=int, default=500)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--episode-length", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument(
        "--set", action="append", metavar="KEY=VALUE", default=[],
        help="override any field of the algorithm's config dataclass, "
        "repeatable (e.g. --set entropy_coef=0.001 --set ppo_epochs=5); "
        "unknown keys are rejected with the valid field list",
    )
    p.add_argument(
        "--config", default=None,
        help="YAML file of config overrides (the v4 parameters.yaml path); "
        "--set takes precedence",
    )
    p.add_argument(
        "--discrete-action", action="store_true",
        help="5-way discrete action env (implied for qmix/vdn variants); "
        "maddpg/ddpg/matd3 switch to the logits actor + gumbel-softmax "
        "update (the reference v2 discrete path), mappo to a categorical "
        "head (onpolicy's ACTLayer discrete branch)",
    )
    p.add_argument(
        "--mesh", default=None, metavar="DP[,TP]",
        help="shard training over a device mesh: env batch data-parallel "
        "over DP devices, network kernels tensor-parallel over TP (default "
        "1).  Works for every --algo, replay buffers included; gradients "
        "reduce over the mesh via the collectives XLA inserts.  The "
        "user-facing scale axis matching the reference's 128-process "
        "rollout fleet (train/mappo/train_formation.sh:13).  num-envs "
        "must divide by DP.  e.g. --mesh 4 or --mesh 4,2",
    )
    p.add_argument(
        "--multihost", action="store_true",
        help="initialize jax.distributed first, from --coordinator, "
        "--num-processes and --process-id; every process runs this same "
        "command and --mesh spans the global device set",
    )
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument(
        "--local-device-ids", default=None, metavar="I[,J...]",
        help="the GPUs of this host that this process takes (one process "
        "per card: its own index); default: every local device",
    )
    p.add_argument(
        "--benchmark", action="store_true",
        help="build the env with benchmark=True and log the per-step "
        "benchmark_data quartet means (bench_reward/collisions/min_dists/"
        "occupied_landmarks) alongside the training metrics — the "
        "reference's make_env(benchmark=True) info_callback "
        "instrumentation (formation_gym/__init__.py:13-14)",
    )
    p.add_argument("--run-dir", default=None)
    p.add_argument("--save-every", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument(
        "--restore", action="store_true",
        help="resume from the latest checkpoint in --run-dir: restores the "
        "FULL training tuple (train state, buffers, env state) and continues "
        "the iteration counter (reference v4 auto-restore behavior)",
    )
    args = p.parse_args()

    if args.multihost:
        from gym_formation_tpu.parallel import initialize_multihost

        initialize_multihost(
            args.coordinator, args.num_processes, args.process_id,
            local_device_ids=(
                [int(i) for i in args.local_device_ids.split(",")]
                if args.local_device_ids else None
            ),
        )

    if args.discrete_action and args.algo not in (
        "maddpg", "ddpg", "matd3", "masac", "mappo", "rmappo",
        "qmix", "vdn", "rqmix", "rvdn",  # discrete already implied: no-op
    ):
        raise SystemExit(
            "--discrete-action is supported by maddpg/ddpg/matd3/masac (the "
            "gumbel-softmax paths) and mappo/rmappo (categorical heads); "
            "qmix/vdn variants are discrete by default"
        )

    kw = {}
    if args.episode_length is not None:
        # every scenario exposes a length kwarg (hd names it episode_length,
        # the others world_length per their reference signatures)
        name = "episode_length" if args.scenario == "formation_hd_env" else "world_length"
        kw[name] = args.episode_length
    env = ft.make_env(
        args.scenario,
        num_agents=args.num_agents,
        benchmark=args.benchmark,
        discrete_action=(
            args.discrete_action or args.algo in DISCRETE_ONLY
        ),
        **kw,
    )

    run_dir = args.run_dir or os.path.join(
        "runs", f"{args.algo}_{args.scenario}_N{args.num_agents}_{int(time.time())}"
    )
    ckpt_dir = os.path.join(run_dir, "ckpt")

    algo, cfg, state = build(args, env)

    if args.mesh:
        from gym_formation_tpu.parallel import parse_mesh_arg, shard_train_tuple

        mesh = parse_mesh_arg(args.mesh)
        dp = mesh.shape["data"]
        if args.num_envs % dp != 0:
            raise SystemExit(
                f"--num-envs {args.num_envs} must divide by the data-parallel "
                f"mesh size {dp}"
            )
        state = shard_train_tuple(args.algo, state, mesh)
        print(f"mesh: {dict(mesh.shape)} over {mesh.devices.size} devices")

    if args.algo in ONPOLICY:
        steps_per_iter = cfg.rollout_len * args.num_envs
    elif args.algo in EPISODIC:
        steps_per_iter = cfg.episodes_per_iter * args.num_envs * env.world_length
    else:
        steps_per_iter = cfg.steps_per_iter * args.num_envs

    start = 0
    if args.restore:
        step = latest_step(ckpt_dir)
        if step is None:
            raise SystemExit(
                f"--restore: no checkpoint found under {ckpt_dir} "
                "(pass the --run-dir of the run to resume)"
            )
        state = list(restore_checkpoint(ckpt_dir, tuple(state), step))
        start = step
        print(f"restored checkpoint at iteration {step} from {ckpt_dir}")

    logger = MetricsLogger(run_dir)
    key = jax.random.PRNGKey(args.seed)
    for i in range(start, start + args.iters):
        *state, m = algo.train_step(*state, jax.random.fold_in(key, i))
        if (i - start) % args.log_every == 0:
            m = {k: float(v) for k, v in m.items()}
            logger.log((i + 1) * steps_per_iter, m)
            print(f"iter {i}: {m}")
        if args.save_every and (i + 1 - start) % args.save_every == 0:
            save_checkpoint(ckpt_dir, i + 1, tuple(state), max_to_keep=2)

    logger.plot("mean_step_reward")
    logger.close()
    print(f"done → {run_dir}")


if __name__ == "__main__":
    main()
