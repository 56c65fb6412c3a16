#!/usr/bin/env python
"""Decompose the N=243 bfs_state rollout step cost on the device.

Variants exploit XLA dead-code elimination *deliberately*: fetching only a
state checksum drops the reward pipeline; replacing the BFS policy with a
constant drops the policy. Differences between variants isolate each
component. (The DCE trap documented in CLAUDE.md is about accidentally
benchmarking less than claimed — here the elimination IS the probe.)

Usage: python tools/exp_step_decomp.py -B 2048 --chunk 64
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
from gym_formation_tpu.utils import enable_compilation_cache

enable_compilation_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-B", "--batch", type=int, default=2048)
    ap.add_argument("--num-agents", type=int, default=243)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--iters", type=int, default=16)
    args = ap.parse_args()

    env = ft.make_env("formation_hd_env", num_agents=args.num_agents)
    B, T = args.batch, args.chunk

    def bfs_policy(state, key):
        return ft.bfs_actions_from_state(
            ft.ezpolicy_batched, env.scenario, state, 3
        )

    def const_policy(state, key):
        return jnp.zeros((args.num_agents, 2), jnp.float32)

    def rollout_state_only(policy):
        # fetches ONLY the final state: XLA eliminates the reward pipeline
        def chunk(state, key):
            def body(carry, _):
                st, k = carry
                k, k_act = jax.random.split(k)
                actions = policy(env.scenario.pre_obs(st), k_act)
                st, _ = env.step(st, actions)
                return (st, k), None

            (state, _), _ = jax.lax.scan(body, (state, key), None, length=T)
            return state, state.pos.sum()

        return chunk

    def rollout_full(policy):
        def chunk(state, key):
            state, rsum = ft.rollout_statepolicy_rewardsum(
                env, policy, state, key, T
            )
            return state, rsum

        return chunk

    env_noreset = ft.FormationEnv(env.scenario, auto_reset=False)

    def rollout_noreset(policy):
        def chunk(state, key):
            def body(carry, _):
                st, k = carry
                k, k_act = jax.random.split(k)
                actions = policy(env.scenario.pre_obs(st), k_act)
                st, _ = env_noreset.step(st, actions)
                return (st, k), None

            (state, _), _ = jax.lax.scan(body, (state, key), None, length=T)
            return state, state.pos.sum()

        return chunk

    cases = {
        "full (bfs+physics+reward)": rollout_full(bfs_policy),
        "no-reward (bfs+physics)": rollout_state_only(bfs_policy),
        "no-reward, const-policy (physics)": rollout_state_only(const_policy),
        "physics, no auto-reset": rollout_noreset(const_policy),
    }

    state = jax.jit(jax.vmap(lambda k: env.reset(k)[0]))(
        jax.random.split(jax.random.PRNGKey(0), B)
    )
    for name, chunk in cases.items():
        run = jax.jit(jax.vmap(chunk))
        st = state
        keys = jax.random.split(jax.random.PRNGKey(1), B)
        st, s = run(st, keys)
        sv = float(s.sum())
        assert math.isfinite(sv), (name, sv)
        t0 = time.perf_counter()
        for i in range(args.iters):
            keys = jax.random.split(jax.random.PRNGKey(2 + i), B)
            st, s = run(st, keys)
        sv = float(s.sum())
        dt = time.perf_counter() - t0
        assert math.isfinite(sv), (name, sv)
        print(
            f"{name:36s}: {dt / args.iters / T * 1e3:.3f} ms/step"
            f"  ({args.iters * B * T / dt / 1e6:.3f} M env-steps/s)"
        )


if __name__ == "__main__":
    main()
