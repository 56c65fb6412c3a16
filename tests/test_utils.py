"""Utility subsystem tests: config, checkpoint, logging, profiling."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import gym_formation_tpu as ft
from gym_formation_tpu.algos import MAPPO, MAPPOConfig
from gym_formation_tpu.utils import (
    MetricsLogger,
    assert_finite,
    from_dict,
    load_config,
    restore_checkpoint,
    save_checkpoint,
    save_config,
)


def test_config_yaml_roundtrip(tmp_path):
    cfg = MAPPOConfig(lr=1e-3, ppo_epochs=5)
    path = str(tmp_path / "cfg.yaml")
    save_config(cfg, path)
    loaded = load_config(MAPPOConfig, path)
    assert loaded == cfg


def test_config_overrides_and_unknown_key(tmp_path):
    cfg = load_config(MAPPOConfig, None, ["lr=0.001", "ppo_epochs=3", "use_value_norm=false"])
    assert cfg.lr == 0.001 and cfg.ppo_epochs == 3 and cfg.use_value_norm is False
    with pytest.raises(ValueError, match="unknown config keys"):
        load_config(MAPPOConfig, None, ["nope=1"])


def test_checkpoint_roundtrip(tmp_path, key):
    env = ft.make_env("formation_hd_env", num_agents=3)
    algo = MAPPO(env, MAPPOConfig(rollout_len=4, ppo_epochs=1), num_envs=4)
    ts, es, obs = algo.init(key)
    ts, es, obs, _ = algo.train_step(ts, es, obs, jax.random.PRNGKey(1))
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, 1, {"ts": ts, "obs": obs})
    restored = restore_checkpoint(path, {"ts": ts, "obs": obs})
    for a, b in zip(jax.tree.leaves(restored["ts"]), jax.tree.leaves(ts)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_metrics_logger(tmp_path):
    logger = MetricsLogger(str(tmp_path / "run"), use_tensorboard=False)
    logger.log(10, {"reward": -1.5})
    logger.log(20, {"reward": -1.0})
    logger.plot("reward")
    logger.close()
    import json

    rows = [json.loads(l) for l in open(tmp_path / "run" / "metrics.jsonl")]
    assert rows[0]["reward"] == -1.5 and rows[1]["step"] == 20
    assert (tmp_path / "run" / "reward.png").exists()


def test_assert_finite():
    assert_finite({"a": jnp.ones(3)})
    with pytest.raises(FloatingPointError, match="non-finite"):
        assert_finite({"a": jnp.array([1.0, jnp.nan])})


def test_train_cli_resume_continues_counter(tmp_path):
    """train.py --restore resumes the iteration counter (new RNG stream,
    checkpoint steps keep increasing) — regression for the review finding
    that resumed runs replayed i=0 and orbax silently dropped saves."""
    import subprocess, sys, os

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = str(tmp_path / "run")
    base = [sys.executable, "train.py", "--algo", "mappo", "--num-envs", "4",
            "--log-every", "1", "--save-every", "2", "--run-dir", run]
    r1 = subprocess.run(base + ["--iters", "2"], capture_output=True, text=True,
                        env=env, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r1.returncode == 0, r1.stderr[-2000:]
    r2 = subprocess.run(base + ["--iters", "2", "--restore"], capture_output=True,
                        text=True, env=env,
                        cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "restored checkpoint at iteration 2" in r2.stdout
    assert "iter 2:" in r2.stdout  # counter continued, not restarted
    ckpts = sorted(
        int(d) for d in os.listdir(os.path.join(run, "ckpt")) if d.isdigit()
    )
    assert ckpts[-1] == 4  # post-resume save landed (not silently dropped)


def test_restore_raw_plain_dicts(tmp_path, key):
    """restore_raw loads without a template onto the local device and returns
    plain containers usable by flax apply."""
    from gym_formation_tpu.utils import restore_raw

    env = ft.make_env("formation_hd_env", num_agents=3)
    algo = MAPPO(env, MAPPOConfig(rollout_len=4, ppo_epochs=1), num_envs=4)
    ts, es, obs = algo.init(key)
    path = str(tmp_path / "raw")
    save_checkpoint(path, 1, (ts, es, obs))
    raw = restore_raw(path)
    ts_raw = raw[0] if isinstance(raw, (list, tuple)) else raw["0"]
    mean, _ = algo.actor.apply(ts_raw["params"]["actor"], obs)
    np.testing.assert_allclose(
        np.asarray(mean), np.asarray(algo.actor.apply(ts.params["actor"], obs)[0]),
        atol=1e-6,
    )
