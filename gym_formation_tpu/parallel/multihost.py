"""Multi-host initialization helpers.

The reference has no real multi-node path (a vestigial gloo all-reduce,
``train/maddpg-v2/utils/misc.py:33-46``, and Ray actors in v3 — SURVEY §2.11).
Here every host runs the SAME program; ``jax.distributed`` wires the
processes, the mesh spans all devices of every host, and the env batch shards
over it — rollouts are embarrassingly parallel and learner gradients reduce
via the collectives XLA inserts under pjit.

Executed in CI by ``tests/test_sharding.py::test_multiprocess_train_step``:
two OS processes federate over a localhost coordinator (CPU backend, 4
virtual devices each), run one sharded MAPPO train_step through
:func:`initialize_multihost` / :func:`pod_mesh` / :func:`per_host_batch` /
:func:`host_local_to_global`, and the metrics match the single-process
8-device run bit-for-bit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import make_mesh


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Initialize jax.distributed.  Pass the coordinator, process count and
    id explicitly: nothing in a CPU or GPU cluster announces them.  When
    several processes share one host's GPUs, give each its own cards with
    ``local_device_ids`` (e.g. ``[process_id]`` for one card per process):
    a JAX process otherwise opens every card of the host and reserves most
    of each one's memory."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def pod_mesh(tp: int = 1, axis_names: Tuple[str, str] = ("data", "model")):
    """Global mesh over every device of every process: data-parallel env
    batch over ``total_devices // tp``, tensor-parallel over ``tp``.

    Call after :func:`initialize_multihost`; the same code runs unchanged on
    one host (``jax.devices()`` is then just the local chips).
    """
    n = len(jax.devices())
    assert n % tp == 0, (n, tp)
    return make_mesh((n // tp, tp), axis_names)


def per_host_batch(global_batch: int) -> int:
    """Env count this host should generate when building a host-local batch
    (``global_batch`` must divide evenly across processes)."""
    p = jax.process_count()
    assert global_batch % p == 0, (global_batch, p)
    return global_batch // p


def host_local_to_global(tree, mesh: Mesh, axis: str = "data"):
    """Assemble a global batch-sharded pytree from per-host local shards.

    Each process passes the ``per_host_batch``-sized slice it generated; the
    result is one global array per leaf, batch-sharded over ``axis`` across
    every device in the pod (the multi-process analogue of
    :func:`~gym_formation_tpu.parallel.mesh.shard_batch`).  Rank-0 leaves are
    replicated and must be identical on every process."""

    def place(x):
        if np.ndim(x) == 0:
            return jax.make_array_from_process_local_data(
                NamedSharding(mesh, P()), np.asarray(x)
            )
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(axis)), np.asarray(x)
        )

    return jax.tree.map(place, tree)


def replicate_global(tree, mesh: Mesh):
    """Replicate identical host data (e.g. network params) onto every device
    of the pod as global arrays."""
    s = NamedSharding(mesh, P())
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(s, np.asarray(x)), tree
    )
