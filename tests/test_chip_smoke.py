"""Where the compile cache goes (utils/compile_cache.py), and chip_smoke.py
off the card: it must refuse to run without a GPU, and its phases must hold
on the CPU at toy sizes, with the kernels interpreted where a phase calls
them directly."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CACHE_PROBE = (
    "import json, jax\n"
    "from gym_formation_tpu.utils import compile_cache as cc\n"
    "d = cc.enable_compilation_cache()\n"
    "print(json.dumps([d, jax.config.jax_compilation_cache_dir, cc.DEFAULT_DIR]))\n"
)


def _probe(tmp_path, **env_vars):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "GFT_COMPILE_CACHE")}
    env.update(JAX_PLATFORMS="cpu", **env_vars)
    r = subprocess.run([sys.executable, "-c", _CACHE_PROBE], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_cache_goes_where_the_environment_says(tmp_path):
    d = str(tmp_path / "cache")
    used, configured, _ = _probe(tmp_path, JAX_COMPILATION_CACHE_DIR=d)
    # JAX reads the variable itself; the code sets no directory of its own
    assert used == d and configured == d


def test_cache_defaults_to_a_fixed_path_in_the_checkout(tmp_path):
    used, configured, default = _probe(tmp_path)
    assert used == configured == default == os.path.join(ROOT, ".jax_cache")
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_cache_can_be_switched_off(tmp_path):
    used, configured, _ = _probe(tmp_path, GFT_COMPILE_CACHE="0")
    assert used is None and not configured


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu", GFT_COMPILE_CACHE="0")
    return subprocess.run([sys.executable, script], capture_output=True, text=True,
                          env=env, cwd=cwd, timeout=300)


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "script_alone"])
def test_chip_smoke_fails_without_a_gpu(alone, tmp_path):
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    r = _run_smoke(cwd, script)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.fixture
def smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    yield chip_smoke
    from gym_formation_tpu.ops import dispatch

    dispatch.set_kernel_mode("auto")


def test_chip_smoke_pairwise_phase_interpreted(smoke):
    smoke.phase_pairwise(B=2, n=27, interpret=True, time_it=False)


@pytest.mark.parametrize(
    "overrides",
    [{}, {"num_agents": 27, "policy": "bfs_state"}, {"scenario": "basic_formation_env"}],
    ids=["hd3", "hd27_bfs_state", "basic3"],
)
def test_chip_smoke_step_comparison(smoke, overrides):
    """Kernels in auto mode against kernels off at highest precision: on
    the CPU both lower the same XLA program, so they agree exactly."""
    args = smoke._suite_args(overrides, num_envs=4)
    assert smoke.compare_steps(args, steps=2) == (0.0, 0.0, 0.0, 0.0)
