"""Device mesh + sharding helpers.

The reference's parallelism is OS processes over pipes plus an unused gloo
all-reduce (SURVEY §2.11).  The equivalents here: the env batch shards over
a ``('data',)`` (or ``('data','model')``) mesh axis so the fleet spans
devices and hosts, model parameters optionally shard over 'model'
(tensor parallelism for wide layers), and gradient reduction is inserted by
XLA when the jitted train step consumes sharded batches — no explicit
collectives in user code.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Tuple[str, ...] = ("data",),
    devices=None,
) -> Mesh:
    """Build a mesh over available devices.

    Defaults to a 1-D ``('data',)`` mesh over all devices.  Pass
    ``shape=(dp, mp), axis_names=('data','model')`` for a 2-D layout.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (devices.size,) + (1,) * (len(axis_names) - 1)
    return Mesh(devices.reshape(shape), axis_names)


def batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Sharding that splits the leading (env-batch) axis over ``axis``."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(tree, mesh: Mesh, axis: str = "data"):
    """Place a pytree with leading batch axes onto the mesh, batch-sharded.

    Leaves with rank 0 are replicated (e.g. scalar counters inside states)."""
    s_batch = batch_sharding(mesh, axis)
    s_rep = replicated(mesh)

    def place(x):
        return jax.device_put(x, s_batch if np.ndim(x) >= 1 else s_rep)

    return jax.tree.map(place, tree)


def parse_mesh_arg(spec: str, devices=None) -> Mesh:
    """Build a ``('data','model')`` mesh from a CLI string ``"DP"`` or
    ``"DP,TP"`` (the user-facing scale axis: the reference exposes its env
    batch as ``--n_rollout_threads 128``, ``train/mappo/train_formation.sh:13``
    — here the same knob is a device-mesh shape)."""
    parts = [int(x) for x in spec.split(",")]
    dp = parts[0]
    tp = parts[1] if len(parts) > 1 else 1
    if len(parts) > 2 or dp < 1 or tp < 1:
        raise ValueError(f"--mesh expects DP or DP,TP; got {spec!r}")
    avail = list(devices if devices is not None else jax.devices())
    if dp * tp > len(avail):
        raise ValueError(
            f"mesh {dp}x{tp} needs {dp * tp} devices, only {len(avail)} "
            f"available (jax.devices())"
        )
    return make_mesh((dp, tp), ("data", "model"), devices=avail[: dp * tp])


# training-state fields holding network parameters → tensor-parallel layout
_PARAM_FIELDS = (
    "params", "actor_params", "critic_params", "target_actor_params",
    "target_critic_params", "q_params", "mixer_params", "target_q_params",
    "target_mixer_params",
)


def shard_train_tuple(name: str, state, mesh: Mesh):
    """Place an algorithm's full training tuple (as returned by
    ``algo.init``) onto ``mesh``: network params tensor-parallel over
    'model', env batch / replay buffers data-parallel over 'data', scalars
    and optimizer state replicated.  Works for all 13 registry algorithms:

    - on-policy ``(ts, env_state, obs[, carry])``: env_state/obs/carry
      batch-sharded;
    - off-policy MLP ``(ts, buffer, env_state, obs)``: the device replay
      buffer shards over its capacity axis, env batch over 'data';
    - episodic recurrent ``(ts, buffer)``: the episode buffer shards over
      its capacity axis (episodes are collected inside the jitted
      train_step, where GSPMD propagates the layout).

    Gradient reduction needs no explicit collectives: consuming a
    data-sharded batch under jit makes XLA insert them (SURVEY §2.11).
    """
    from ..algos.registry import EPISODIC, ONPOLICY

    out = list(state)
    ts = out[0]
    for f in _PARAM_FIELDS:
        if hasattr(ts, f):
            p = getattr(ts, f)
            ts = ts.replace(
                **{f: jax.device_put(p, model_sharding_for_params(p, mesh))}
            )
    if hasattr(ts, "ou_state"):  # [num_envs, N, da] exploration state
        ts = ts.replace(ou_state=shard_batch(ts.ou_state, mesh))
    out[0] = ts
    for i in range(1, len(out)):
        out[i] = shard_batch(out[i], mesh)
    return out


def model_sharding_for_params(params, mesh: Mesh, axis: str = "model"):
    """Tensor-parallel layout for MLP params: shard the widest axis of each
    kernel over ``axis`` when divisible; replicate everything else.

    For the 64-hidden baselines this is demonstration-scale TP; it becomes
    load-bearing for wide actor/critic stacks and the N=243 centralized
    critic whose input dim is O(N·obs_dim).
    """
    size = mesh.shape[axis]

    def spec(x):
        if np.ndim(x) >= 2 and x.shape[-1] % size == 0:
            return NamedSharding(mesh, P(*([None] * (np.ndim(x) - 1) + [axis])))
        return NamedSharding(mesh, P())

    return jax.tree.map(spec, params)
