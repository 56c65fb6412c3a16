"""Universal checkpoint-eval registry: every --algo name restores to a greedy
eval policy (the reference ships one evaluate/render driver per trainer
generation — train/maddpg-v2/evaluate.py, train/maddpg-v5/render.py,
train/mappo/inbox/render_formation.py; here one registry covers all 13)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import gym_formation_tpu as ft
from gym_formation_tpu.algos.registry import (
    ALGO_NAMES,
    DISCRETE_ONLY,
    RECURRENT,
    eval_policy,
    make_algo,
)

# small configs so init is cheap on the CPU harness
FAST_SETS = {
    "mappo": ["rollout_len=4", "ppo_epochs=1"],
    "rmappo": ["rollout_len=4", "ppo_epochs=1", "data_chunk_length=2"],
    "maddpg": ["buffer_size=256"],
    "ddpg": ["buffer_size=256"],
    "matd3": ["buffer_size=256"],
    "masac": ["buffer_size=256"],
    "qmix": ["buffer_size=256"],
    "vdn": ["buffer_size=256"],
    "rmaddpg": ["buffer_episodes=8"],
    "rmatd3": ["buffer_episodes=8"],
    "rmasac": ["buffer_episodes=8"],
    "rqmix": ["buffer_episodes=8"],
    "rvdn": ["buffer_episodes=8"],
}


def _state_dict(x):
    """Plain nested dicts of a pytree of dataclasses and namedtuples, keyed
    by field name: the containers a template-free checkpoint restore
    gives back."""
    import dataclasses

    if dataclasses.is_dataclass(x):
        return {f.name: _state_dict(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if hasattr(x, "_fields"):
        return {k: _state_dict(v) for k, v in zip(x._fields, x)}
    if isinstance(x, dict):
        return {k: _state_dict(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_state_dict(v) for v in x)
    return x


@pytest.mark.parametrize("name", ALGO_NAMES)
def test_eval_policy_for_every_algo(name, key):
    """init → state-dict (the restore_raw view) → greedy policy → actions of
    the right shape/kind, recurrent carries threaded across steps."""
    env = ft.make_env(
        "formation_hd_env", num_agents=3, episode_length=8,
        discrete_action=name in DISCRETE_ONLY,
    )
    algo = make_algo(name, env, num_envs=2, sets=FAST_SETS[name])
    state = algo.init(key)
    ts_raw = _state_dict(state[0])  # what restore_raw returns for element 0

    B = 2
    policy, carry = eval_policy(name, algo, ts_raw, batch_size=B)
    obs = jax.random.normal(jax.random.PRNGKey(1), (B, 3, env.scenario.obs_dim))
    for _ in range(2):  # two steps: recurrent carries must thread
        a, carry = policy(obs, carry)
    a = np.asarray(a)
    assert a.shape == (B, 3, env.act_dim)
    assert np.all(np.isfinite(a))
    if name in DISCRETE_ONLY:
        assert np.allclose(a.sum(-1), 1.0) and set(np.unique(a)) <= {0.0, 1.0}
    else:
        assert np.all(np.abs(a) <= 1.0 + 1e-6)  # clipped to the control range
    if name in RECURRENT:
        assert carry is not None and not bool(carry[1].any())  # resets cleared
        assert np.asarray(carry[0]).shape == (B, 3, algo.cfg.gru_hidden)


@pytest.mark.parametrize("name", ["mappo", "rqmix"])
def test_checkpoint_roundtrip_eval(name, key, tmp_path):
    """train_step → save_checkpoint → restore_raw → eval drives the env
    (the eval.py --policy ckpt path, one MLP + one recurrent family)."""
    from gym_formation_tpu.utils import restore_raw, save_checkpoint

    env = ft.make_env(
        "formation_hd_env", num_agents=3, episode_length=8,
        discrete_action=name in DISCRETE_ONLY,
    )
    algo = make_algo(name, env, num_envs=2, sets=FAST_SETS[name])
    state = list(algo.init(key))
    state = list(algo.train_step(*state, jax.random.PRNGKey(1)))[:-1]
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, 1, tuple(state))

    raw = restore_raw(ckpt)
    ts_raw = raw[0] if isinstance(raw, (list, tuple)) else raw["ts"]
    policy, carry = eval_policy(name, algo, ts_raw, batch_size=1)

    eval_env = ft.make_env(
        "formation_hd_env", num_agents=3, episode_length=8, auto_reset=False,
        discrete_action=name in DISCRETE_ONLY,
    )
    st, obs = eval_env.reset(jax.random.PRNGKey(2))
    step = jax.jit(
        lambda st, obs, carry: (
            lambda a, c: (eval_env.step(st, a[0]), c)
        )(*policy(obs[None], carry))
    )
    done, t = False, 0
    while not done:
        (st, out), carry = step(st, obs, carry)
        obs = out.obs
        done, t = bool(out.done.all()), t + 1
    assert t == 8
    assert np.isfinite(float(out.reward[0]))
