"""The GPU pair kernels (ops/gpu/pairwise.py) in Pallas interpret mode, and
the one dispatch point that chooses them (ops/dispatch.py).

The kernels are compiled only for CUDA; on the CPU they run through the
Pallas interpreter (``interpret=True``), which checks their arithmetic,
padding and tiling.  ``chip_smoke.py`` checks them compiled, on the card.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import gym_formation_tpu as ft
from gym_formation_tpu.core import make_world_cfg, physics
from gym_formation_tpu.ops import dispatch
from gym_formation_tpu.ops.gpu.pairwise import (
    collision_forces_pairwise,
    hd_stats_pairwise,
    padded_rows,
    sym_applicable,
)

SIZES = (3, 9, 27, 81, 243)


@pytest.fixture(autouse=True)
def _auto_mode():
    yield
    dispatch.set_kernel_mode("auto")


def _f64_forces(pos, cfg):
    """Direct-delta double-precision reference of core.py:288-322."""
    pos = np.asarray(pos, np.float64)
    delta = pos[:, None, :] - pos[None, :, :]
    dist = np.sqrt((delta**2).sum(-1))
    dmin = cfg.size[:, None] + cfg.size[None, :]
    k = cfg.contact_margin
    pen = np.logaddexp(0.0, -(dist - dmin) / k) * k
    eps = 1e-12 if cfg.nan_guard else 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        coef = cfg.contact_force * pen / np.maximum(dist, eps)
    ok = ~np.eye(len(pos), dtype=bool)
    w = np.where(ok, coef, 0.0)
    return np.einsum("ij,ijp->ip", w, delta)


def _f64_stats(apos, ishape, thresh):
    a = np.asarray(apos, np.float64)
    a = a - a.mean(axis=0)
    s = np.asarray(ishape, np.float64)
    d = np.linalg.norm(a[:, None] - s[None], axis=-1)
    haus = max(d.min(axis=1).max(), d.min(axis=0).max())
    r = np.asarray(apos, np.float64)
    dd = np.linalg.norm(r[:, None] - r[None], axis=-1)
    count = ((dd < thresh) & ~np.eye(len(r), dtype=bool)).sum(axis=1)
    return haus, count


def _positions(n, B=3, seed=0):
    pos = jax.random.uniform(jax.random.PRNGKey(seed), (B, n, 2), jnp.float32, -0.5, 0.5)
    if n >= 3:  # one pair at the contact distance, one deep inside it
        pos = pos.at[:, 1].set(pos[:, 0] + jnp.asarray([0.06, 0.0], jnp.float32))
        pos = pos.at[:, 2].set(pos[:, 0] + jnp.asarray([0.0, 0.0301], jnp.float32))
    return pos


@pytest.mark.parametrize("nan_guard", [True, False])
@pytest.mark.parametrize("n", SIZES)
def test_forces_match_f64_oracle_and_xla(n, nan_guard):
    cfg = make_world_cfg(n, 0, agent_size=0.03, nan_guard=nan_guard)
    pos = _positions(n)
    out = np.asarray(collision_forces_pairwise(pos, cfg, interpret=True))
    xla = np.asarray(jax.vmap(lambda p: physics._collision_forces_xla(p, cfg))(pos))
    assert out.shape == pos.shape
    for b in range(pos.shape[0]):
        np.testing.assert_allclose(out[b], _f64_forces(pos[b], cfg), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(out, xla, atol=1e-4 * max(1.0, np.abs(xla).max()))


@pytest.mark.parametrize("n", SIZES)
def test_stats_match_f64_oracle_and_xla(n):
    env = ft.make_env("formation_hd_env", num_agents=n)
    st = jax.vmap(lambda k: env.reset(k)[0])(jax.random.split(jax.random.PRNGKey(n), 3))
    apos = st.pos[:, :n]
    apos = apos.at[:, 1].set(apos[:, 0] + 0.01)  # a collision in every env
    thresh = float(2.0 * env.cfg.size[0] * env.scenario.collision_factor)
    haus, count = hd_stats_pairwise(apos, st.ideal_shape, thresh=thresh, interpret=True)
    h_x, c_x = jax.vmap(env.scenario._hd_stats_xla)(apos, st.ideal_shape)
    np.testing.assert_allclose(np.asarray(haus), np.asarray(h_x), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(count), np.asarray(c_x))
    for b in range(3):
        h64, c64 = _f64_stats(apos[b], st.ideal_shape[b], thresh)
        np.testing.assert_allclose(float(haus[b]), h64, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(count[b]), c64)
        assert c64[0] >= 1 and c64[1] >= 1


@pytest.mark.parametrize("nan_guard", [True, False])
def test_coincident_pair_follows_nan_guard(nan_guard):
    """Zero separation: 0/0 is NaN without the guard (the reference's
    behaviour) and finite with it, in the kernel as in the XLA path."""
    cfg = make_world_cfg(9, 0, agent_size=0.03, nan_guard=nan_guard)
    pos = _positions(9, B=2)
    pos = pos.at[:, 4].set(pos[:, 3])
    out = np.asarray(collision_forces_pairwise(pos, cfg, interpret=True))
    xla = np.asarray(jax.vmap(lambda p: physics._collision_forces_xla(p, cfg))(pos))
    assert np.isnan(out[:, 3]).any() == (not nan_guard)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(xla))


@pytest.mark.parametrize("n,rows", [(3, 16), (16, 16), (17, 32), (100, 128), (243, 256)])
def test_padding_rows(n, rows):
    assert padded_rows(n) == rows


@pytest.mark.parametrize(
    "config",
    [
        dict(tile_rows=16, tile_cols=16),
        dict(tile_rows=64, tile_cols=32, num_warps=4),
        dict(tile_rows=128, tile_cols=128),  # tiles wider than the padded rows
    ],
)
def test_force_tilings_agree(config):
    cfg = make_world_cfg(81, 0, agent_size=0.03)
    pos = _positions(81, B=2, seed=4)
    ref = collision_forces_pairwise(pos, cfg, interpret=True)
    out = collision_forces_pairwise(pos, cfg, interpret=True, **config)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("tile", [16, 64])
def test_stats_tilings_agree(tile):
    env = ft.make_env("formation_hd_env", num_agents=81)
    st = jax.vmap(lambda k: env.reset(k)[0])(jax.random.split(jax.random.PRNGKey(2), 2))
    args = (st.pos[:, :81], st.ideal_shape)
    ref = hd_stats_pairwise(*args, thresh=0.03, interpret=True)
    out = hd_stats_pairwise(*args, thresh=0.03, interpret=True, tile=tile)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_sym_applicability_gate():
    """sym_applicable rejects heterogeneous worlds (mixed mass/size or
    non-colliding members); the kernel refuses them."""
    het = make_world_cfg(100, 156, agent_size=0.05, landmark_size=0.04,
                         landmark_collide=True, landmark_movable=True)
    assert not sym_applicable(het)  # mixed sizes
    uni = make_world_cfg(64, 0, agent_size=0.03, landmark_size=0.01)
    assert sym_applicable(uni)
    uni.mass[3] = 2.0
    assert not sym_applicable(uni)
    with pytest.raises(ValueError):
        collision_forces_pairwise(jnp.zeros((1, 64, 2), jnp.float32), uni, interpret=True)


@pytest.mark.parametrize(
    "scenario,n", [("formation_hd_env", 27), ("formation_hd_env", 81), ("basic_formation_env", 9)]
)
def test_kernel_dispatch_through_env_step(scenario, n):
    """The forced mode routes the vmapped env step through both kernels and
    matches the XLA path."""
    env = ft.make_env(scenario, num_agents=n)
    venv = ft.VecFormationEnv(env, num_envs=3)
    st, _ = venv.reset(jax.random.PRNGKey(0))
    acts = venv.sample_actions(jax.random.PRNGKey(1))
    st_x, out_x = venv.step(st, acts)
    dispatch.set_kernel_mode("on", interpret=True)
    venv_k = ft.VecFormationEnv(env, num_envs=3)
    st, _ = venv_k.reset(jax.random.PRNGKey(0))
    st_k, out_k = venv_k.step(st, acts)
    np.testing.assert_allclose(np.asarray(st_k.pos), np.asarray(st_x.pos), atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_k.reward), np.asarray(out_x.reward), rtol=1e-5)


def test_forced_mode_rejects_ineligible_world():
    """Obstacles of another size take the world off the force kernel's
    envelope: the forced mode raises instead of falling back to XLA."""
    env = ft.make_env("formation_hd_obs_env", num_agents=3)
    assert not sym_applicable(physics._collide_subset(env.cfg)[3])
    dispatch.set_kernel_mode("on", interpret=True)
    venv = ft.VecFormationEnv(env, num_envs=2)
    st, _ = venv.reset(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="kernel mode 'on'"):
        venv.step(st, venv.sample_actions(jax.random.PRNGKey(1)))


@pytest.mark.parametrize("n", [3, 243])
def test_forced_mode_raises_off_gpu(n):
    env = ft.make_env("formation_hd_env", num_agents=n)
    dispatch.set_kernel_mode("on")
    venv = ft.VecFormationEnv(env, num_envs=2)
    st, _ = venv.reset(jax.random.PRNGKey(0))
    with pytest.raises(RuntimeError, match="needs a GPU"):
        venv.step(st, venv.sample_actions(jax.random.PRNGKey(1)))


def test_auto_mode_lowers_plain_xla_on_cpu():
    """auto at N=243 (above the size threshold) lowers no kernel for the
    CPU: platform_dependent keeps the CUDA branch out of the program."""
    env = ft.make_env("formation_hd_env", num_agents=243)
    assert 243 >= dispatch.MIN_ENTITIES
    st = jax.vmap(lambda k: env.reset(k)[0])(jax.random.split(jax.random.PRNGKey(0), 2))
    acts = jnp.zeros((2, 243, 2), jnp.float32)
    hlo = jax.jit(jax.vmap(env.step)).lower(st, acts).as_text()
    assert "triton" not in hlo.lower()


def test_set_kernel_mode_validates():
    with pytest.raises(ValueError):
        dispatch.set_kernel_mode("sometimes")
    with pytest.raises(ValueError):
        dispatch.set_kernel_mode("auto", interpret=True)
    dispatch.set_kernel_mode("off")
    assert dispatch._mode == "off"


@pytest.mark.parametrize(
    "mode,entities,ineligible,expect",
    [
        ("off", 243, None, "xla"),
        ("auto", 3, None, "xla"),
        ("auto", 243, "no", "xla"),
        ("on", 3, None, "kernel"),
    ],
)
def test_choose_by_mode(mode, entities, ineligible, expect):
    dispatch.set_kernel_mode(mode, interpret=mode == "on")
    out = dispatch.choose(
        lambda x, interpret=False: "kernel", lambda x: "xla", 0,
        entities=entities, ineligible=ineligible,
    )
    assert out == expect


def test_sharded_rollout_runs_kernel_per_shard():
    """bench.py's --mesh body runs under shard_map, so each device steps its
    own slice of envs through the kernel: 8 CPU devices, interpret mode,
    against the unsharded batch."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    import importlib.util
    import os

    import gym_formation_tpu.utils.compile_cache as cc

    prev = (jax.config.jax_compilation_cache_dir, cc._enabled_dir)
    try:
        spec = importlib.util.spec_from_file_location(
            "bench", os.path.join(os.path.dirname(__file__), "..", "bench.py")
        )
        bench = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bench)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev[0])
        cc._enabled_dir = prev[1]
    args = bench.build_parser().parse_args(
        ["--num-agents", "27", "--policy", "bfs_state", "--num-envs", "16"]
    )
    dispatch.set_kernel_mode("on", interpret=True)
    out = {}
    for mesh in (None, 8):
        args.mesh = mesh
        _, reset, run_chunk = bench.build(args, 3)
        state, obs = reset(jax.random.PRNGKey(0))
        state, _, r = run_chunk(state, obs, jax.random.PRNGKey(1))
        out[mesh] = (np.asarray(state.pos), np.asarray(r))
    np.testing.assert_allclose(out[8][0], out[None][0], atol=1e-6)
    np.testing.assert_allclose(out[8][1], out[None][1], rtol=1e-6)


def _need_gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py phases b and c run this on the card)")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [27, 243])
def test_compiled_kernels_match_xla_on_gpu(n):
    _need_gpu()
    cfg = make_world_cfg(n, 0, agent_size=0.03)
    pos = _positions(n, B=64)
    with jax.default_matmul_precision("highest"):
        xla = jax.vmap(lambda p: physics._collision_forces_xla(p, cfg))(pos)
    out = collision_forces_pairwise(pos, cfg)
    np.testing.assert_allclose(np.asarray(out), np.asarray(xla),
                               atol=1e-4 * float(jnp.abs(xla).max()))
    env = ft.make_env("formation_hd_env", num_agents=n)
    st = jax.vmap(lambda k: env.reset(k)[0])(jax.random.split(jax.random.PRNGKey(n), 64))
    h, c = hd_stats_pairwise(st.pos[:, :n], st.ideal_shape, thresh=0.03)
    h_x, c_x = jax.vmap(env.scenario._hd_stats_xla)(st.pos[:, :n], st.ideal_shape)
    np.testing.assert_allclose(np.asarray(h), np.asarray(h_x), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(c), np.asarray(c_x))


@pytest.mark.gpu
def test_forced_mode_runs_compiled_kernels_on_gpu():
    _need_gpu()
    env = ft.make_env("formation_hd_env", num_agents=81)
    venv = ft.VecFormationEnv(env, num_envs=64)
    st, _ = venv.reset(jax.random.PRNGKey(0))
    acts = venv.sample_actions(jax.random.PRNGKey(1))
    _, out_x = venv.step(st, acts)
    dispatch.set_kernel_mode("on")
    venv_k = ft.VecFormationEnv(env, num_envs=64)
    st, _ = venv_k.reset(jax.random.PRNGKey(0))
    _, out_k = venv_k.step(st, acts)
    np.testing.assert_allclose(np.asarray(out_k.reward), np.asarray(out_x.reward), rtol=1e-4)
