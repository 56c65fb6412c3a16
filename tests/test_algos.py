"""Learner tests: MAPPO / MADDPG machinery and short learning-progress runs."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import gym_formation_tpu as ft

# the off-policy learners build their networks with flax (an optional extra)
pytest.importorskip("flax")

from gym_formation_tpu.algos import (  # noqa: E402
    MADDPG,
    MADDPGConfig,
    MAPPO,
    MAPPOConfig,
    ReplayBuffer,
    ValueNorm,
)


def test_value_norm_roundtrip():
    vn = ValueNorm.create()
    x = jnp.asarray(np.random.RandomState(0).randn(1000) * 5 + 3)
    vn = vn.update(x)
    z = vn.normalize(x)
    assert abs(float(z.mean())) < 0.2
    np.testing.assert_allclose(np.asarray(vn.denormalize(z)), np.asarray(x), atol=1e-4)


def test_replay_buffer_ring_and_sample(key):
    buf = ReplayBuffer.create(10, 3, 4, 2)
    obs = jnp.arange(6 * 3 * 4, dtype=jnp.float32).reshape(6, 3, 4)
    act = jnp.zeros((6, 3, 2))
    rew = jnp.ones((6, 3))
    done = jnp.zeros((6,), bool)
    buf = buf.insert(obs, act, rew, obs, done)
    assert int(buf.size) == 6 and int(buf.ptr) == 6
    buf = buf.insert(obs, act, rew, obs, done)  # wraps: 12 > 10
    assert int(buf.size) == 10 and int(buf.ptr) == 2
    batch = buf.sample(key, 4)
    assert batch["obs"].shape == (4, 3, 4)


def test_mappo_train_step_runs_and_updates(key):
    env = ft.make_env("formation_hd_env", num_agents=3)
    algo = MAPPO(env, MAPPOConfig(rollout_len=8, ppo_epochs=2, num_minibatches=2), num_envs=8)
    ts, es, obs = algo.init(key)
    p0 = jax.tree.leaves(ts.params)[0].copy()
    ts, es, obs, m = algo.train_step(ts, es, obs, jax.random.PRNGKey(1))
    assert np.isfinite(float(m["pg_loss"]))
    assert np.isfinite(float(m["v_loss"]))
    assert int(ts.update_i) == 1
    assert not np.allclose(np.asarray(jax.tree.leaves(ts.params)[0]), np.asarray(p0))
    # ppo with identical policy: first-epoch KL should be ~0 at start
    assert abs(float(m["approx_kl"])) < 1.0


def test_mappo_learns_on_easy_objective():
    """A few iterations should improve the critic's explained variance /
    reduce value loss on the stationary random-policy distribution."""
    env = ft.make_env("formation_hd_env", num_agents=3)
    algo = MAPPO(env, MAPPOConfig(rollout_len=16, ppo_epochs=4, lr=1e-3), num_envs=16)
    ts, es, obs = algo.init(jax.random.PRNGKey(0))
    losses = []
    for i in range(8):
        ts, es, obs, m = algo.train_step(ts, es, obs, jax.random.PRNGKey(i + 1))
        losses.append(float(m["v_loss"]))
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses


def test_maddpg_train_step_runs(key):
    env = ft.make_env("formation_hd_env", num_agents=3)
    algo = MADDPG(
        env,
        MADDPGConfig(buffer_size=4096, steps_per_iter=4, updates_per_iter=2, batch_size=64),
        num_envs=8,
    )
    ts, buf, es, obs = algo.init(key)
    # 4 steps × 8 envs = 32 transitions < batch 64 → updates skipped
    ts, buf, es, obs, m = algo.train_step(ts, buf, es, obs, jax.random.PRNGKey(1))
    assert float(m["critic_loss"]) == 0.0
    assert int(m["buffer_size"]) == 32
    ts, buf, es, obs, m = algo.train_step(ts, buf, es, obs, jax.random.PRNGKey(2))
    assert np.isfinite(float(m["critic_loss"])) and float(m["critic_loss"]) > 0
    assert float(ts.noise) < MADDPGConfig().noise_rate  # decay applied
    acts = algo.eval_actions(ts, obs)
    assert acts.shape == (8, 3, 2)
    assert float(jnp.max(jnp.abs(acts))) <= 1.0


def test_maddpg_per_agent_params_differ(key):
    env = ft.make_env("formation_hd_env", num_agents=3)
    algo = MADDPG(env, num_envs=4)
    ts, *_ = algo.init(key)
    kernels = [
        l for p, l in jax.tree_util.tree_leaves_with_path(ts.actor_params)
        if "kernel" in jax.tree_util.keystr(p)
    ]
    assert kernels and all(k.shape[0] == 3 for k in kernels)
    assert not np.allclose(np.asarray(kernels[0][0]), np.asarray(kernels[0][1]))


def _offpolicy_smoke(algo_builder, n_iters=3):
    env = ft.make_env("formation_hd_env", num_agents=3)
    algo = algo_builder(env)
    ts, buf, es, obs = algo.init(jax.random.PRNGKey(0))
    for i in range(n_iters):
        ts, buf, es, obs, m = algo.train_step(ts, buf, es, obs, jax.random.PRNGKey(i))
    return algo, ts, obs, m


def test_matd3_runs_and_delays_actor():
    from gym_formation_tpu.algos import MATD3, MATD3Config

    algo, ts, obs, m = _offpolicy_smoke(
        lambda env: MATD3(
            env,
            MATD3Config(buffer_size=2048, steps_per_iter=8, updates_per_iter=4, batch_size=64),
            num_envs=8,
        )
    )
    assert np.isfinite(float(m["critic_loss"])) and float(m["critic_loss"]) > 0
    assert int(ts.grad_updates) == 12  # 3 iterations × 4 updates (buffer full at iter 1)
    acts = algo.eval_actions(ts, obs)
    assert float(jnp.max(jnp.abs(acts))) <= 1.0


def test_masac_runs_and_tunes_alpha():
    from gym_formation_tpu.algos import MASAC, MASACConfig

    algo, ts, obs, m = _offpolicy_smoke(
        lambda env: MASAC(
            env,
            MASACConfig(
                buffer_size=2048, steps_per_iter=8, updates_per_iter=4,
                batch_size=64, warmup_random_steps=32,
            ),
            num_envs=8,
        )
    )
    assert np.isfinite(float(m["critic_loss"]))
    assert float(m["alpha"]) != MASACConfig().init_alpha  # temperature moved
    assert np.isfinite(float(m["entropy"]))


def test_ddpg_local_critic_mode():
    algo, ts, obs, m = _offpolicy_smoke(
        lambda env: MADDPG(
            env,
            MADDPGConfig(
                centralized=False, buffer_size=2048, steps_per_iter=8,
                updates_per_iter=2, batch_size=64,
            ),
            num_envs=8,
        )
    )
    # local critic input = one agent's obs+act
    kernels = [
        l for p, l in jax.tree_util.tree_leaves_with_path(ts.critic_params)
        if "kernel" in jax.tree_util.keystr(p)
    ]
    in_dims = {k.shape[-2] for k in kernels}
    assert 18 + 2 in in_dims  # obs_dim + act_dim of ONE agent
    assert 3 * (18 + 2) not in in_dims  # not the centralized input


@pytest.mark.parametrize("mixer", ["qmix", "vdn"])
def test_qmix_vdn_run_and_learn_shapes(mixer):
    from gym_formation_tpu.algos import QMix, QMixConfig

    env = ft.make_env("formation_hd_env", num_agents=3)
    denv = ft.FormationEnv(env.scenario, discrete_action=True)
    algo = QMix(
        denv,
        QMixConfig(mixer=mixer, buffer_size=2048, steps_per_iter=8,
                   updates_per_iter=2, batch_size=64, eps_anneal_steps=100),
        num_envs=8,
    )
    ts, buf, es, obs = algo.init(jax.random.PRNGKey(0))
    for i in range(3):
        ts, buf, es, obs, m = algo.train_step(ts, buf, es, obs, jax.random.PRNGKey(i))
    assert np.isfinite(float(m["q_loss"])) and float(m["q_loss"]) > 0
    assert float(m["epsilon"]) < 1.0  # anneal progressed
    acts = algo.eval_actions(ts, obs)
    assert acts.shape == (8, 3, 5)
    np.testing.assert_allclose(np.asarray(acts.sum(-1)), 1.0)  # one-hot


def test_rmappo_runs_and_resets_hidden():
    from gym_formation_tpu.algos import RMAPPO, RMAPPOConfig

    scen = ft.make_scenario("formation_hd_env", num_agents=3, episode_length=5)
    env = ft.FormationEnv(scen)
    algo = RMAPPO(
        env,
        RMAPPOConfig(rollout_len=10, data_chunk_length=5, ppo_epochs=2, num_minibatches=1),
        num_envs=8,
    )
    ts, es, obs, carry = algo.init(jax.random.PRNGKey(0))
    p0 = np.asarray(jax.tree.leaves(ts.params)[0]).copy()
    for i in range(3):
        ts, es, obs, carry, m = algo.train_step(ts, es, obs, carry, jax.random.PRNGKey(i))
    assert np.isfinite(float(m["v_loss"]))
    assert not np.allclose(np.asarray(jax.tree.leaves(ts.params)[0]), p0)
    assert carry.h_actor.shape == (8, 3, 64)
    # episodes end every 5 steps inside the 10-step rollout → done flags seen
    a, carry2 = algo.act(ts.params, obs, carry)
    assert a.shape == (8, 3, 2)


def test_rmaddpg_and_rmatd3_run():
    from gym_formation_tpu.algos import RMADDPG, RMADDPGConfig

    scen = ft.make_scenario("formation_hd_env", num_agents=3, episode_length=8)
    env = ft.FormationEnv(scen)
    for twin in (False, True):
        algo = RMADDPG(
            env,
            RMADDPGConfig(buffer_episodes=64, batch_episodes=4,
                          episodes_per_iter=2, updates_per_iter=2, twin=twin),
            num_envs=4,
        )
        ts, buf = algo.init(jax.random.PRNGKey(0))
        for i in range(3):
            ts, buf, m = algo.train_step(ts, buf, jax.random.PRNGKey(i))
        assert np.isfinite(float(m["critic_loss"])) and float(m["critic_loss"]) > 0
        # greedy recurrent eval over a stored episode shape
        acts = algo.eval_actions_episode(ts, jnp.zeros((2, 8, 3, 18)))
        assert acts.shape == (2, 8, 3, 2)
        assert float(jnp.max(jnp.abs(acts))) <= 1.0


@pytest.mark.parametrize("mixer", ["qmix", "vdn"])
def test_recurrent_qmix_vdn_run(mixer):
    from gym_formation_tpu.algos import RQMix, RQMixConfig

    scen = ft.make_scenario("formation_hd_env", num_agents=3, episode_length=8)
    env = ft.FormationEnv(scen, discrete_action=True)
    algo = RQMix(
        env,
        RQMixConfig(mixer=mixer, buffer_episodes=64, batch_episodes=4,
                    episodes_per_iter=2, updates_per_iter=2, eps_anneal_steps=200),
        num_envs=4,
    )
    ts, buf = algo.init(jax.random.PRNGKey(0))
    for i in range(3):
        ts, buf, m = algo.train_step(ts, buf, jax.random.PRNGKey(i))
    assert np.isfinite(float(m["q_loss"])) and float(m["q_loss"]) > 0
    assert float(m["epsilon"]) < 1.0


def test_mappo_separated_policy():
    from gym_formation_tpu.algos import MAPPO, MAPPOConfig

    env = ft.make_env("formation_hd_env", num_agents=3)
    algo = MAPPO(
        env, MAPPOConfig(rollout_len=8, ppo_epochs=2, share_policy=False), num_envs=8
    )
    ts, es, obs = algo.init(jax.random.PRNGKey(0))
    kernels = [
        l for p, l in jax.tree_util.tree_leaves_with_path(ts.params["actor"])
        if "kernel" in jax.tree_util.keystr(p)
    ]
    assert all(k.shape[0] == 3 for k in kernels)  # stacked per-agent
    ts, es, obs, m = algo.train_step(ts, es, obs, jax.random.PRNGKey(1))
    assert np.isfinite(float(m["v_loss"]))
    a = algo.act(ts.params, obs)
    assert a.shape == (8, 3, 2)


def test_per_buffer_and_maddpg_integration(key):
    from gym_formation_tpu.algos.per import PrioritizedReplayBuffer, beta_schedule

    buf = PrioritizedReplayBuffer.create(32, 3, 4, 2)
    obs = jnp.ones((8, 3, 4))
    buf = buf.insert(obs, jnp.zeros((8, 3, 2)), jnp.ones((8, 3)), obs, jnp.zeros((8,), bool))
    batch, idx, w = buf.sample_prioritized(key, 16, alpha=0.6, beta=jnp.asarray(0.4))
    assert batch["obs"].shape == (16, 3, 4)
    assert float(jnp.max(w)) == 1.0 and float(jnp.min(w)) > 0
    # raising one transition's priority should dominate sampling
    buf = buf.update_priorities(jnp.array([3]), jnp.array([1000.0]))
    _, idx2, _ = buf.sample_prioritized(jax.random.PRNGKey(5), 64, alpha=1.0, beta=jnp.asarray(1.0))
    assert int(jnp.sum(idx2 == 3)) > 32  # majority from the hot index
    assert float(beta_schedule(jnp.asarray(0))) == 0.4
    assert float(beta_schedule(jnp.asarray(10**9))) == 1.0

    env = ft.make_env("formation_hd_env", num_agents=3)
    algo = MADDPG(
        env,
        MADDPGConfig(use_per=True, buffer_size=1024, steps_per_iter=8,
                     updates_per_iter=2, batch_size=64),
        num_envs=8,
    )
    ts, buf, es, obs = algo.init(jax.random.PRNGKey(0))
    for i in range(2):
        ts, buf, es, obs, m = algo.train_step(ts, buf, es, obs, jax.random.PRNGKey(i))
    assert np.isfinite(float(m["critic_loss"]))
    pr = np.asarray(buf.priority)
    assert len(np.unique(pr[pr > 0])) > 10  # priorities got TD-updated


def test_rmasac_runs_and_tunes_alpha():
    from gym_formation_tpu.algos import RMASAC, RMASACConfig

    scen = ft.make_scenario("formation_hd_env", num_agents=3, episode_length=8)
    env = ft.FormationEnv(scen)
    algo = RMASAC(
        env,
        RMASACConfig(buffer_episodes=64, batch_episodes=4,
                     episodes_per_iter=2, updates_per_iter=2),
        num_envs=4,
    )
    ts, buf = algo.init(jax.random.PRNGKey(0))
    for i in range(3):
        ts, buf, m = algo.train_step(ts, buf, jax.random.PRNGKey(i))
    assert np.isfinite(float(m["critic_loss"])) and float(m["critic_loss"]) > 0
    assert float(m["alpha"]) != RMASACConfig().init_alpha
    assert np.isfinite(float(m["entropy"]))


def test_offpolicy_terminal_next_obs_not_reset_obs(key):
    """Regression (code review): with auto-reset envs the buffer must store
    the TRUE pre-reset obs as next_obs, not the next episode's initial obs."""
    scen = ft.make_scenario("formation_hd_env", num_agents=3, episode_length=2)
    env = ft.FormationEnv(scen)  # auto_reset on
    algo = MADDPG(
        env,
        MADDPGConfig(buffer_size=64, steps_per_iter=2, updates_per_iter=0, batch_size=4),
        num_envs=1,
    )
    ts, buf, es, obs = algo.init(key)
    ts, buf, es, obs, _ = algo.train_step(ts, buf, es, obs, jax.random.PRNGKey(1))
    # step 2 hits the time limit: the stored transition must chain
    # continuously from the stored obs (velocities consistent), while the
    # post-step live obs (reset) differs from stored next_obs
    stored_next = np.asarray(buf.next_obs[1])
    live_obs = np.asarray(obs[0])
    assert not np.allclose(stored_next, live_obs)  # reset obs NOT stored
    # and the terminal transition's next_obs follows from its obs via physics:
    # same ideal_shape block (episode unchanged within the transition)
    n = 3
    assert np.allclose(
        np.asarray(buf.obs[1])[:, 4 * n - 2 : 6 * n - 2],
        stored_next[:, 4 * n - 2 : 6 * n - 2],
        atol=1e-6,
    )


def test_maddpg_discrete_gumbel_path(key):
    """Discrete env → logits actor, one-hot actions through env + critic
    (the reference v2 discrete path: maddpg-v2/algorithms/maddpg.py:166-180)."""
    env = ft.make_env("formation_hd_env", num_agents=3, discrete_action=True)
    algo = MADDPG(
        env,
        MADDPGConfig(buffer_size=1024, steps_per_iter=16, updates_per_iter=2,
                     batch_size=64),
        num_envs=8,
    )
    assert algo.discrete and env.act_dim == 5
    ts, buf, es, obs = algo.init(key)
    ts, buf, es, obs, m = algo.train_step(ts, buf, es, obs, jax.random.PRNGKey(1))
    assert np.isfinite(float(m["critic_loss"])) and float(m["critic_loss"]) > 0
    # exploration and eval actions are exact one-hots
    acts, _ = jax.jit(algo.explore_actions)(ts, obs, jax.random.PRNGKey(2))
    acts = np.asarray(acts)
    assert acts.shape == (8, 3, 5)
    assert np.allclose(acts.sum(-1), 1.0) and set(np.unique(acts)) == {0.0, 1.0}
    ev = np.asarray(algo.eval_actions(ts, obs))
    assert np.allclose(ev.sum(-1), 1.0) and set(np.unique(ev)) == {0.0, 1.0}


def test_matd3_discrete_runs():
    from gym_formation_tpu.algos import MATD3, MATD3Config

    env = ft.make_env("formation_hd_env", num_agents=3, discrete_action=True)
    algo = MATD3(
        env,
        MATD3Config(buffer_size=1024, steps_per_iter=16, updates_per_iter=2,
                    batch_size=64),
        num_envs=8,
    )
    ts, buf, es, obs = algo.init(jax.random.PRNGKey(0))
    for i in range(2):
        ts, buf, es, obs, m = algo.train_step(ts, buf, es, obs, jax.random.PRNGKey(i))
    assert np.isfinite(float(m["critic_loss"])) and float(m["critic_loss"]) > 0
    ev = np.asarray(algo.eval_actions(ts, obs))
    assert np.allclose(ev.sum(-1), 1.0)


def test_mappo_discrete_categorical_head(key):
    """Discrete env → categorical actor (onpolicy ACTLayer's discrete
    branch): one-hot actions, finite losses, improving value loss."""
    from gym_formation_tpu.algos import MAPPO, MAPPOConfig

    env = ft.make_env("formation_hd_env", num_agents=3, discrete_action=True)
    algo = MAPPO(env, MAPPOConfig(rollout_len=16, ppo_epochs=4, lr=1e-3), num_envs=16)
    assert algo.discrete
    ts, es, obs = algo.init(key)
    losses = []
    for i in range(6):
        ts, es, obs, m = algo.train_step(ts, es, obs, jax.random.PRNGKey(i + 1))
        assert np.isfinite(float(m["pg_loss"])) and np.isfinite(float(m["entropy"]))
        losses.append(float(m["v_loss"]))
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
    # deterministic + stochastic actions are exact one-hots
    det = np.asarray(algo.act(ts.params, obs))
    sto = np.asarray(algo.act(ts.params, obs, jax.random.PRNGKey(9), deterministic=False))
    for a in (det, sto):
        assert a.shape == (16, 3, 5)
        assert np.allclose(a.sum(-1), 1.0) and set(np.unique(a)) == {0.0, 1.0}


def test_mappo_discrete_separated_policy(key):
    from gym_formation_tpu.algos import MAPPO, MAPPOConfig

    env = ft.make_env("formation_hd_env", num_agents=3, discrete_action=True)
    algo = MAPPO(
        env,
        MAPPOConfig(rollout_len=8, ppo_epochs=2, share_policy=False),
        num_envs=8,
    )
    ts, es, obs = algo.init(key)
    ts, es, obs, m = algo.train_step(ts, es, obs, jax.random.PRNGKey(1))
    assert np.isfinite(float(m["pg_loss"]))
    a = np.asarray(algo.act(ts.params, obs))
    assert a.shape == (8, 3, 5) and np.allclose(a.sum(-1), 1.0)


def test_masac_discrete_gumbel_sac():
    """Discrete env → gumbel-softmax SAC: one-hot actions, positive target
    entropy (0.6·log|A|, the shipped target_entropy_ratio), finite losses,
    alpha autotunes."""
    from gym_formation_tpu.algos import MASAC, MASACConfig

    env = ft.make_env("formation_hd_env", num_agents=3, discrete_action=True)
    algo = MASAC(
        env,
        MASACConfig(buffer_size=1024, steps_per_iter=16, updates_per_iter=4,
                    batch_size=64, warmup_random_steps=32),
        num_envs=8,
    )
    assert algo.discrete and algo.target_entropy > 0
    ts, buf, es, obs = algo.init(jax.random.PRNGKey(0))
    for i in range(3):
        ts, buf, es, obs, m = algo.train_step(ts, buf, es, obs, jax.random.PRNGKey(i))
    assert np.isfinite(float(m["critic_loss"])) and float(m["critic_loss"]) > 0
    assert float(m["alpha"]) != MASACConfig().init_alpha  # autotuned
    # entropy metric is a single-sample MC estimate of -E[logp]: near the
    # categorical range but with sampling variance
    assert 0.0 < float(m["entropy"]) <= np.log(5) + 0.1
    ev = np.asarray(algo.eval_actions(ts, obs))
    assert ev.shape == (8, 3, 5)
    assert np.allclose(ev.sum(-1), 1.0) and set(np.unique(ev)) == {0.0, 1.0}
    ex = np.asarray(jax.jit(algo.explore_actions)(ts, obs, jax.random.PRNGKey(5)))
    assert np.allclose(ex.sum(-1), 1.0)


def test_rmappo_discrete_recurrent_categorical(key):
    from gym_formation_tpu.algos import RMAPPO, RMAPPOConfig

    env = ft.make_env("formation_hd_env", num_agents=3, discrete_action=True)
    algo = RMAPPO(
        env,
        RMAPPOConfig(rollout_len=10, data_chunk_length=5, ppo_epochs=2),
        num_envs=8,
    )
    assert algo.discrete and algo.actor.discrete
    ts, es, obs, carry = algo.init(key)
    for i in range(2):
        ts, es, obs, carry, m = algo.train_step(ts, es, obs, carry, jax.random.PRNGKey(i))
    assert np.isfinite(float(m["pg_loss"])) and np.isfinite(float(m["entropy"]))
    a, carry = jax.jit(lambda p, o, c: algo.act(p, o, c))(ts.params, obs, carry)
    a = np.asarray(a)
    assert a.shape == (8, 3, 5)
    assert np.allclose(a.sum(-1), 1.0) and set(np.unique(a)) == {0.0, 1.0}


@pytest.mark.parametrize("name,iters", [("rmaddpg", 30), ("rqmix", 60)])
def test_recurrent_learning_signal(name, iters):
    """Recurrent off-policy learners IMPROVE, not just run: the per-step
    training reward trends up over a miniature version of the measured
    RESULTS.md zoo protocol (the full 2M-step runs live in RESULTS.md §zoo;
    this guards the learning signal in CI)."""
    from gym_formation_tpu.algos.registry import DISCRETE_ONLY, make_algo

    env = ft.make_env(
        "formation_hd_env", num_agents=3, episode_length=8,
        discrete_action=name in DISCRETE_ONLY,
    )
    algo = make_algo(
        name, env, num_envs=16,
        sets=["episodes_per_iter=4", "updates_per_iter=8", "batch_episodes=16",
              "buffer_episodes=256"]
        + (["eps_anneal_steps=5000"] if name == "rqmix"
           else ["lr_actor=1e-3", "lr_critic=1e-3"]),
    )
    state = list(algo.init(jax.random.PRNGKey(0)))
    rews = []
    for i in range(iters):
        *state, m = algo.train_step(*state, jax.random.PRNGKey(i + 1))
        rews.append(float(m["mean_step_reward"]))
    assert np.isfinite(rews).all()
    assert np.mean(rews[-5:]) > np.mean(rews[:5]) + 0.1, rews
