"""MAPPO's plain-JAX networks (models/networks.py) against the flax.linen
modules they replace, the local pytree dataclass (core/struct.py), and the
package's independence from flax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gym_formation_tpu.core import struct
from gym_formation_tpu.models import networks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flax_modules():
    """The flax.linen definitions these networks had before."""
    import flax.linen as nn

    class MLP(nn.Module):
        features: tuple

        @nn.compact
        def __call__(self, x):
            for f in self.features:
                x = nn.relu(nn.Dense(f, kernel_init=networks.orthogonal_init())(x))
            return x

    class GaussianActor(nn.Module):
        act_dim: int
        hidden: tuple = (64, 64)

        @nn.compact
        def __call__(self, obs):
            h = MLP(self.hidden)(obs)
            mean = nn.Dense(self.act_dim, kernel_init=networks.orthogonal_init(0.01))(h)
            log_std = self.param("log_std", nn.initializers.constant(0.0), (self.act_dim,))
            log_std = networks.soft_bound(log_std, -5.0, 2.0)
            return mean, jnp.broadcast_to(log_std, mean.shape)

    class ValueCritic(nn.Module):
        hidden: tuple = (64, 64)

        @nn.compact
        def __call__(self, x):
            h = MLP(self.hidden)(x)
            return nn.Dense(1, kernel_init=networks.orthogonal_init(1.0))(h).squeeze(-1)

    class LogitsActor(nn.Module):
        n_actions: int
        hidden: tuple = (64, 64, 64)

        @nn.compact
        def __call__(self, obs):
            h = MLP(self.hidden)(obs)
            return nn.Dense(self.n_actions, kernel_init=networks.orthogonal_init(0.01))(h)

    return {
        "gaussian": (GaussianActor(2), networks.GaussianActor(2)),
        "value": (ValueCritic(), networks.ValueCritic()),
        "logits": (LogitsActor(5), networks.LogitsActor(5)),
    }


NETS = ["gaussian", "value", "logits"]


@pytest.mark.parametrize("name", NETS)
def test_forward_matches_flax_module(name):
    """Same parameter tree as the flax module; same outputs on its params."""
    pytest.importorskip("flax")
    old, new = _flax_modules()[name]
    x = jax.random.normal(jax.random.PRNGKey(0), (7, 18), jnp.float32)
    p_old = old.init(jax.random.PRNGKey(1), x)
    p_new = new.init(jax.random.PRNGKey(1), x)
    shapes = lambda p: jax.tree.map(lambda a: a.shape, p)
    assert jax.tree_util.tree_structure(p_old) == jax.tree_util.tree_structure(p_new)
    assert shapes(p_old) == shapes(p_new)
    out_old = old.apply(p_old, x)
    out_new = new.apply(p_old, x)
    for a, b in zip(jax.tree.leaves(out_old), jax.tree.leaves(out_new)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize(
    "net,head_scale",
    [
        (networks.GaussianActor(2, (64, 64)), 0.01),
        (networks.ValueCritic((64, 64)), 1.0),
        (networks.LogitsActor(5, (32, 32, 32)), 0.01),
    ],
)
def test_shapes_and_orthogonal_init_scale(net, head_scale):
    x = jnp.zeros((4, 18), jnp.float32)
    p = net.init(jax.random.PRNGKey(3), x)["params"]
    fan_in = 18
    for i, width in enumerate(net.hidden):
        assert p["MLP_0"][f"Dense_{i}"]["kernel"].dtype == jnp.float32
        k = np.asarray(p["MLP_0"][f"Dense_{i}"]["kernel"], np.float64)
        assert k.shape == (fan_in, width)
        np.testing.assert_array_equal(np.asarray(p["MLP_0"][f"Dense_{i}"]["bias"]), 0.0)
        # orthogonal with gain sqrt(2): the smaller Gram matrix is 2 I
        g = k.T @ k if fan_in >= width else k @ k.T
        np.testing.assert_allclose(g, 2.0 * np.eye(len(g)), atol=1e-5)
        fan_in = width
    head = np.asarray(p["Dense_0"]["kernel"], np.float64)
    assert head.shape == (fan_in, net.out_dim)
    np.testing.assert_allclose(head.T @ head, head_scale**2 * np.eye(net.out_dim), atol=1e-6)
    out = net.apply({"params": p}, x)
    first = out[0] if isinstance(out, tuple) else out
    assert first.shape == ((4,) if net.out_dim == 1 else (4, net.out_dim))


def test_struct_dataclass_is_a_pytree_with_replace_and_static_fields():
    @struct.dataclass
    class S:
        a: jnp.ndarray
        b: dict
        tag: str = struct.field(pytree_node=False, default="x")

    s = S(a=jnp.ones(3), b={"c": jnp.zeros(2)})
    leaves, tree = jax.tree_util.tree_flatten(s)
    assert len(leaves) == 2  # the static field is not a leaf
    s2 = jax.jit(lambda s: jax.tree.map(lambda v: v + 1, s))(s)
    assert s2.tag == "x" and float(s2.a[0]) == 2.0
    s3 = s2.replace(tag="y")
    assert s3.tag == "y" and s2.tag == "x"
    with pytest.raises(Exception):
        s.a = None  # frozen


_NO_FLAX = (
    "import sys\n"
    "for m in ('flax', 'flax.linen', 'flax.struct', 'flax.serialization'):\n"
    "    sys.modules[m] = None\n"
)


@pytest.mark.parametrize(
    "code",
    [
        "import gym_formation_tpu, gym_formation_tpu.algos.mappo",
        "import jax, gym_formation_tpu as ft\n"
        "from gym_formation_tpu.algos import MAPPO, MAPPOConfig\n"
        "env = ft.make_env('formation_hd_env', num_agents=3)\n"
        "a = MAPPO(env, MAPPOConfig(rollout_len=2, ppo_epochs=1), num_envs=2)\n"
        "ts, es, obs = a.init(jax.random.PRNGKey(0))\n"
        "a.train_step(ts, es, obs, jax.random.PRNGKey(1))",
        "sys.argv = ['bench.py', '--num-envs', '4', '--chunk', '2', '--iters', '1',"
        " '--windows', '1']\n"
        "import runpy; runpy.run_path('bench.py', run_name='__main__')",
        "sys.argv = ['train.py', '--algo', 'mappo', '--num-envs', '2', '--iters', '1',"
        " '--save-every', '0', '--set', 'rollout_len=2', '--set', 'ppo_epochs=1',"
        " '--run-dir', sys.argv[1]]\n"
        "import runpy; runpy.run_path('train.py', run_name='__main__')",
    ],
    ids=["import", "mappo_step", "bench", "train_mappo"],
)
def test_main_path_runs_without_flax(code, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", GFT_COMPILE_CACHE="0")
    r = subprocess.run(
        [sys.executable, "-c", _NO_FLAX + code, str(tmp_path / "run")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
