"""Checkpoint / resume via orbax.

The reference saves only torch ``state_dict`` pickles per agent
(``maddpg-v1/maddpg/maddpg.py:39-46,107-116``; optimizer state only in v2,
``maddpg-v2/utils/agents.py:77-83``) and never checkpoints env or RNG state
(SURVEY §5).  Here a checkpoint is the complete training pytree — params,
optimizer state, value-norm stats, env state, observations and RNG key — so a
restored run continues bit-identically.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax


def _manager(path: str, max_to_keep: int = 5):
    import orbax.checkpoint as ocp

    return ocp.CheckpointManager(
        os.path.abspath(path),
        options=ocp.CheckpointManagerOptions(max_to_keep=max_to_keep, create=True),
    )


def save_checkpoint(path: str, step: int, tree: Any, max_to_keep: int = 5) -> None:
    """Save an arbitrary pytree under ``path/<step>``."""
    import orbax.checkpoint as ocp

    mgr = _manager(path, max_to_keep)
    mgr.save(step, args=ocp.args.StandardSave(tree))
    mgr.wait_until_finished()
    mgr.close()


def restore_checkpoint(path: str, target: Any, step: Optional[int] = None) -> Any:
    """Restore the latest (or given) step into the structure of ``target``."""
    import orbax.checkpoint as ocp

    mgr = _manager(path)
    if step is None:
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    out = mgr.restore(
        step, args=ocp.args.StandardRestore(jax.tree.map(lambda x: x, target))
    )
    mgr.close()
    return out


def restore_raw(path: str, step: Optional[int] = None) -> Any:
    """Restore without a template: returns the stored pytree with plain
    dict/list containers (flax ``apply`` accepts these directly).  Useful
    when the consumer doesn't know the saved shapes (e.g. eval restoring a
    policy from a training checkpoint of unknown batch size).  Every leaf is
    restored onto the local default device, so checkpoints written on a
    different device type (GPU → CPU eval) load cleanly.
    """
    import orbax.checkpoint as ocp

    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    item_dir = os.path.join(os.path.abspath(path), str(step), "default")
    ckptr = ocp.PyTreeCheckpointer()
    tree = ckptr.metadata(item_dir).item_metadata.tree
    dev = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    restore_args = jax.tree.map(lambda m: ocp.ArrayRestoreArgs(sharding=dev), tree)
    return ckptr.restore(item_dir, args=ocp.args.PyTreeRestore(restore_args=restore_args))


def latest_step(path: str) -> Optional[int]:
    import orbax.checkpoint as ocp

    if not os.path.isdir(path):
        return None
    mgr = _manager(path)
    step = mgr.latest_step()
    mgr.close()
    return step
