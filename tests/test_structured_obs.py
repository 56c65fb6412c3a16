"""Parity of the factorized (obs-free) hd first layers
(models/structured_obs.py) against the naive ``obs @ W`` path, and of the
structured MAPPO trajectory against the obs-storing one."""

import math
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import gym_formation_tpu as ft
from gym_formation_tpu.algos import MAPPO, MAPPOConfig
from gym_formation_tpu.models.networks import GaussianActor, ValueCritic
from gym_formation_tpu.models.structured_obs import (
    actor_forward_structured,
    critic_forward_structured,
    hd_actor_h1,
    hd_critic_h1,
)


def _setup(N, B, key):
    env = ft.make_env("formation_hd_env", num_agents=N)
    state, obs = jax.vmap(env.reset)(jax.random.split(key, B))
    parts = (
        state.pos[:, :N],
        state.vel[:, :N],
        state.ideal_shape,
        state.ideal_vel,
    )
    return env, np.asarray(obs), parts


def test_structured_first_layers_match_obs_matmul():
    """h1 = obs @ W + b reproduced from O(N) state (prefix/suffix sums for
    the slot-shifted others_rel blocks; V/U precomputes for the critic)."""
    for N in (27, 243):
        env, obs, parts = _setup(N, 4, jax.random.PRNGKey(N))
        do = 6 * N
        actor = GaussianActor(2, (64, 64))
        critic = ValueCritic((64, 64))
        pa = actor.init(jax.random.PRNGKey(1), jnp.zeros((1, do)))
        pc = critic.init(jax.random.PRNGKey(2), jnp.zeros((1, N * do)))
        W = pa["params"]["MLP_0"]["Dense_0"]["kernel"]
        b = pa["params"]["MLP_0"]["Dense_0"]["bias"]
        np.testing.assert_allclose(
            np.asarray(hd_actor_h1(W, b, *parts)),
            obs @ np.asarray(W) + np.asarray(b),
            atol=2e-5,
        )
        Wc = pc["params"]["MLP_0"]["Dense_0"]["kernel"]
        bc = pc["params"]["MLP_0"]["Dense_0"]["bias"]
        np.testing.assert_allclose(
            np.asarray(hd_critic_h1(Wc, bc, *parts)),
            obs.reshape(4, N * do) @ np.asarray(Wc) + np.asarray(bc),
            atol=5e-5,
        )
        # full forwards
        m_ref, _ = actor.apply(pa, jnp.asarray(obs))
        m, _ = actor_forward_structured(pa, *parts, (64, 64))
        np.testing.assert_allclose(np.asarray(m), np.asarray(m_ref), atol=1e-6)
        v_ref = critic.apply(pc, jnp.asarray(obs.reshape(4, N * do)))
        v = critic_forward_structured(pc, *parts, (64, 64))
        np.testing.assert_allclose(np.asarray(v), np.asarray(v_ref), atol=2e-5)


def test_structured_train_step_matches_naive():
    """One full MAPPO iteration with the structured trajectory reproduces
    the obs-storing iteration's metrics (same seeds)."""
    env = ft.make_env("formation_hd_env", num_agents=27)
    out = {}
    for mode in (True, False):
        algo = MAPPO(
            env,
            MAPPOConfig(rollout_len=6, ppo_epochs=2, structured_obs=mode),
            num_envs=8,
        )
        assert algo.structured_obs is mode
        ts, es, obs = algo.init(jax.random.PRNGKey(0))
        ts, es, obs, m = algo.train_step(ts, es, obs, jax.random.PRNGKey(10))
        out[mode] = {k: float(v) for k, v in m.items()}
        assert all(math.isfinite(v) for v in out[mode].values())
    for k, v in out[True].items():
        np.testing.assert_allclose(v, out[False][k], rtol=2e-3, atol=1e-4,
                                   err_msg=k)


def test_structured_auto_gate():
    """auto: ON for hd at N>=32, OFF for small N / discrete / other
    scenarios; forcing on an ineligible config raises."""
    hd_big = ft.make_env("formation_hd_env", num_agents=81)
    assert MAPPO(hd_big, MAPPOConfig(), num_envs=4).structured_obs
    hd_small = ft.make_env("formation_hd_env", num_agents=3)
    assert not MAPPO(hd_small, MAPPOConfig(), num_envs=4).structured_obs
    basic = ft.make_env("basic_formation_env", num_agents=33)
    assert not MAPPO(basic, MAPPOConfig(), num_envs=4).structured_obs
    import pytest

    with pytest.raises(AssertionError):
        MAPPO(basic, MAPPOConfig(structured_obs=True), num_envs=4)


def test_grad_accum_and_remat_match_plain_update():
    """grad_accum chunking and remat are exact levers: one train iteration
    produces the same metrics as the plain whole-batch gradient (same seeds;
    f32-reassociation tolerance)."""
    env = ft.make_env("formation_hd_env", num_agents=27)
    out = {}
    for tag, kw in (
        ("plain", {}),
        ("accum4", dict(grad_accum=4)),
        ("remat", dict(remat=True)),
    ):
        algo = MAPPO(
            env,
            MAPPOConfig(rollout_len=6, ppo_epochs=2, structured_obs=True, **kw),
            num_envs=8,
        )
        ts, es, obs = algo.init(jax.random.PRNGKey(0))
        ts, es, obs, m = algo.train_step(ts, es, obs, jax.random.PRNGKey(10))
        out[tag] = {k: float(v) for k, v in m.items()}
        assert all(math.isfinite(v) for v in out[tag].values())
    for tag in ("accum4", "remat"):
        for k, v in out[tag].items():
            np.testing.assert_allclose(
                v, out["plain"][k], rtol=2e-3, atol=1e-4, err_msg=(tag, k)
            )


def test_structured_bf16_forward_close():
    """structured_bf16 is a flagged precision change: the bf16 actor
    forward tracks the f32 one to bf16 tolerance."""
    env, obs, parts = _setup(27, 4, jax.random.PRNGKey(7))
    actor = GaussianActor(2, (64, 64))
    pa = actor.init(jax.random.PRNGKey(1), jnp.zeros((1, 6 * 27)))
    m32, _ = actor_forward_structured(pa, *parts, (64, 64))
    m16, ls16 = actor_forward_structured(
        pa, *parts, (64, 64), dtype=jnp.bfloat16
    )
    assert m16.dtype == jnp.float32  # distribution params return f32
    np.testing.assert_allclose(
        np.asarray(m16), np.asarray(m32), atol=5e-2
    )


@pytest.mark.skipif(
    os.environ.get("GFT_RUN_BF16_TRAIN", "0") != "1",
    reason="the bf16 train_step segfaults XLA:CPU's compiler in long "
    "suite sessions (passes standalone); set GFT_RUN_BF16_TRAIN=1 to run",
)
def test_structured_bf16_train_close_and_learns():
    """One full bf16 iteration's metrics stay within tolerance of the f32
    path and training stays finite."""
    env = ft.make_env("formation_hd_env", num_agents=27)
    out = {}
    for bf16 in (False, True):
        algo = MAPPO(
            env,
            MAPPOConfig(
                rollout_len=6, ppo_epochs=2, structured_obs=True,
                structured_bf16=bf16,
            ),
            num_envs=8,
        )
        ts, es, obs = algo.init(jax.random.PRNGKey(0))
        for i in range(3):
            ts, es, obs, m = algo.train_step(
                ts, es, obs, jax.random.PRNGKey(10 + i)
            )
            mm = {k: float(v) for k, v in m.items()}
            assert all(math.isfinite(v) for v in mm.values()), (bf16, mm)
        out[bf16] = mm
    # loose agreement: same order of magnitude dynamics, not exactness
    np.testing.assert_allclose(
        out[True]["mean_step_reward"], out[False]["mean_step_reward"],
        rtol=0.3,
    )


def test_auto_entropy_targets_alpha():
    """auto_entropy: α moves log-linearly toward holding entropy at the
    target — rising while entropy is under target, falling above — and
    training stays finite (the fixed-coefficient cliff regression of the
    r5 N=243 campaign)."""
    env = ft.make_env("formation_hd_env", num_agents=3)
    # target far above the init entropy (~2.84 at sigma=1): alpha must RISE
    algo_hi = MAPPO(
        env,
        MAPPOConfig(rollout_len=5, ppo_epochs=2, auto_entropy=True,
                    entropy_target=5.0),
        num_envs=8,
    )
    ts, es, obs = algo_hi.init(jax.random.PRNGKey(0))
    a0 = float(ts.params["log_alpha"])
    for i in range(3):
        ts, es, obs, m = algo_hi.train_step(ts, es, obs, jax.random.PRNGKey(i))
        assert all(math.isfinite(float(v)) for v in m.values())
    assert float(m["alpha"]) > a0  # pushing entropy up toward 5.0

    # target far below: alpha must FALL
    algo_lo = MAPPO(
        env,
        MAPPOConfig(rollout_len=5, ppo_epochs=2, auto_entropy=True,
                    entropy_target=-3.0),
        num_envs=8,
    )
    ts, es, obs = algo_lo.init(jax.random.PRNGKey(0))
    for i in range(3):
        ts, es, obs, m = algo_lo.train_step(ts, es, obs, jax.random.PRNGKey(i))
    # signed alpha: over-target entropy drives it below the init, toward
    # (and past) zero — the entropy-penalty regime SAC's exp(alpha) forbids
    assert float(m["alpha"]) < a0

    # grad_accum composes with the alpha metric key
    algo_ga = MAPPO(
        env,
        MAPPOConfig(rollout_len=5, ppo_epochs=1, auto_entropy=True,
                    grad_accum=2),
        num_envs=8,
    )
    ts, es, obs = algo_ga.init(jax.random.PRNGKey(0))
    ts, es, obs, m = algo_ga.train_step(ts, es, obs, jax.random.PRNGKey(5))
    assert "alpha" in m and math.isfinite(float(m["alpha"]))


def test_structured_multi_iter_learning_signal():
    """A few structured iterations keep finite metrics and move v_loss."""
    env = ft.make_env("formation_hd_env", num_agents=27)
    algo = MAPPO(
        env,
        MAPPOConfig(rollout_len=8, ppo_epochs=2, structured_obs=True),
        num_envs=8,
    )
    ts, es, obs = algo.init(jax.random.PRNGKey(3))
    vlosses = []
    for i in range(4):
        ts, es, obs, m = algo.train_step(ts, es, obs, jax.random.PRNGKey(20 + i))
        assert all(math.isfinite(float(v)) for v in m.values())
        vlosses.append(float(m["v_loss"]))
    assert vlosses[-1] < vlosses[0]  # the critic is fitting
