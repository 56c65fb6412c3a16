#!/usr/bin/env python
"""Single-agent DQN on a JAX CartPole — orientation demo.

Parity item for the reference's ``train/ddpg/test.py`` (a tianshou DQN on
CartPole used purely as a collector/trainer API demo — SURVEY §2.10).  Here
the same demo runs as one program: CartPole dynamics as a pure jitted step (classic
Barto-Sutton cart-pole equations), vectorized envs, device replay buffer, and
a DQN update — all in one compiled program per iteration.

    python examples/dqn_cartpole.py --iters 150
"""

import argparse
import os
import sys
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax
import flax.linen as nn
from flax import struct

# -- CartPole-v1 dynamics (standard constants) -------------------------------
GRAVITY, MASSCART, MASSPOLE, LENGTH = 9.8, 1.0, 0.1, 0.5
FORCE_MAG, TAU = 10.0, 0.02
THETA_LIMIT, X_LIMIT, MAX_STEPS = 12 * 2 * np.pi / 360, 2.4, 500


@struct.dataclass
class CPState:
    s: jnp.ndarray  # [4]: x, x_dot, theta, theta_dot
    t: jnp.ndarray
    key: jnp.ndarray


def cp_reset(key):
    key, k = jax.random.split(key)
    s = jax.random.uniform(k, (4,), jnp.float32, -0.05, 0.05)
    return CPState(s=s, t=jnp.zeros((), jnp.int32), key=key)


def cp_step(state: CPState, action):
    x, x_dot, th, th_dot = state.s
    force = jnp.where(action == 1, FORCE_MAG, -FORCE_MAG)
    total_m = MASSCART + MASSPOLE
    pm_l = MASSPOLE * LENGTH
    temp = (force + pm_l * th_dot**2 * jnp.sin(th)) / total_m
    th_acc = (GRAVITY * jnp.sin(th) - jnp.cos(th) * temp) / (
        LENGTH * (4.0 / 3.0 - MASSPOLE * jnp.cos(th) ** 2 / total_m)
    )
    x_acc = temp - pm_l * th_acc * jnp.cos(th) / total_m
    s = jnp.array(
        [x + TAU * x_dot, x_dot + TAU * x_acc, th + TAU * th_dot, th_dot + TAU * th_acc]
    )
    t = state.t + 1
    done = (
        (jnp.abs(s[0]) > X_LIMIT) | (jnp.abs(s[2]) > THETA_LIMIT) | (t >= MAX_STEPS)
    )
    # auto-reset
    key, k_reset = jax.random.split(state.key)
    fresh = cp_reset(k_reset)
    nxt = jax.tree.map(
        lambda a, b: jnp.where(done, a, b),
        fresh,
        CPState(s=s, t=t, key=key),
    )
    return nxt, (jnp.where(done, fresh.s, s), 1.0, done)


class QNet(nn.Module):
    @nn.compact
    def __call__(self, x):
        x = nn.relu(nn.Dense(128)(x))
        x = nn.relu(nn.Dense(128)(x))
        return nn.Dense(2)(x)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=150)
    p.add_argument("--num-envs", type=int, default=32)
    p.add_argument("--steps-per-iter", type=int, default=64)
    args = p.parse_args()

    B = args.num_envs
    qnet = QNet()
    key = jax.random.PRNGKey(0)
    params = qnet.init(key, jnp.zeros((1, 4)))
    target = params
    tx = optax.adam(1e-3)
    opt = tx.init(params)
    states = jax.jit(jax.vmap(cp_reset))(jax.random.split(key, B))
    obs = states.s

    cap = 50_000
    buf = {
        "obs": jnp.zeros((cap, 4)),
        "act": jnp.zeros((cap,), jnp.int32),
        "rew": jnp.zeros((cap,)),
        "next": jnp.zeros((cap, 4)),
        "done": jnp.zeros((cap,), bool),
    }
    ptr = jnp.zeros((), jnp.int32)
    size = jnp.zeros((), jnp.int32)

    @jax.jit
    def iteration(params, target, opt, states, obs, buf, ptr, size, key, eps):
        def env_step(carry, k):
            states, obs, buf, ptr, size = carry
            q = qnet.apply(params, obs)
            greedy = jnp.argmax(q, -1)
            rand = jax.random.randint(jax.random.fold_in(k, 0), (B,), 0, 2)
            act = jnp.where(jax.random.uniform(jax.random.fold_in(k, 1), (B,)) < eps, rand, greedy)
            states, (next_obs, rew, done) = jax.vmap(cp_step)(states, act)
            idx = (ptr + jnp.arange(B)) % cap
            buf = dict(
                obs=buf["obs"].at[idx].set(obs),
                act=buf["act"].at[idx].set(act),
                rew=buf["rew"].at[idx].set(rew),
                next=buf["next"].at[idx].set(next_obs),
                done=buf["done"].at[idx].set(done),
            )
            return (states, next_obs, buf, (ptr + B) % cap, jnp.minimum(size + B, cap)), done.sum()

        (states, obs, buf, ptr, size), dones = jax.lax.scan(
            env_step, (states, obs, buf, ptr, size),
            jax.random.split(key, args.steps_per_iter),
        )

        def update(carry, k):
            params, opt = carry
            idx = jax.random.randint(k, (128,), 0, jnp.maximum(size, 1))
            b = jax.tree.map(lambda x: x[idx], buf)
            q_next = qnet.apply(target, b["next"]).max(-1)
            y = b["rew"] + 0.99 * q_next * (1 - b["done"])

            def loss(p):
                q = jnp.take_along_axis(
                    qnet.apply(p, b["obs"]), b["act"][:, None], -1
                ).squeeze(-1)
                return jnp.mean((q - jax.lax.stop_gradient(y)) ** 2)

            g = jax.grad(loss)(params)
            upd, opt = tx.update(g, opt)
            return (optax.apply_updates(params, upd), opt), loss(params)

        (params, opt), losses = jax.lax.scan(
            update, (params, opt), jax.random.split(jax.random.fold_in(key, 9), 8)
        )
        return params, opt, states, obs, buf, ptr, size, losses.mean(), dones.sum()

    ep_len_est = []
    for i in range(args.iters):
        eps = max(0.05, 1.0 - i / (args.iters * 0.6))
        key, k = jax.random.split(key)
        params, opt, states, obs, buf, ptr, size, loss, n_done = iteration(
            params, target, opt, states, obs, buf, ptr, size, k, eps
        )
        if i % 10 == 0:
            target = params
        steps = B * args.steps_per_iter
        ep_len = steps / max(int(n_done), 1)
        ep_len_est.append(ep_len)
        if i % 20 == 0:
            print(f"iter {i}: eps={eps:.2f} loss={float(loss):.4f} mean_ep_len≈{ep_len:.1f}")
    print(f"final mean episode length ≈ {np.mean(ep_len_est[-10:]):.1f} (500 = solved)")


if __name__ == "__main__":
    main()
