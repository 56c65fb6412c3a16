"""The one place that chooses between a GPU kernel and plain XLA.

Modes (:func:`set_kernel_mode`):

- ``auto`` (default): the kernel where the computation is lowered for CUDA
  and the world has at least :data:`MIN_ENTITIES` colliding entities, plain
  XLA everywhere else.  The choice is made per lowering platform
  (``lax.platform_dependent``), so arrays committed to the CPU on a GPU
  machine still take the XLA path.
- ``on``: the kernel, or an error.  Off a GPU, or for an input the kernel
  cannot take, it raises; it never falls back.  ``interpret=True`` (tests
  only) runs the kernel through the Pallas interpreter instead.
- ``off``: plain XLA.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax

MODES = ("auto", "on", "off")

# auto takes the kernel from this many colliding entities up.  On an H100 the
# hd bfs_state rollout at 4096 envs ran 2% slower with the kernels at N=27
# and 1.26x and 1.93x faster at N=81 and N=243 (PERF.md, kernel decisions).
MIN_ENTITIES = 64

_mode = "auto"
_interpret = False


def set_kernel_mode(mode: str, *, interpret: bool = False) -> None:
    """Select ``auto``, ``on`` or ``off`` (see the module docstring)."""
    global _mode, _interpret
    if mode not in MODES:
        raise ValueError(f"kernel mode must be one of {MODES}, got {mode!r}")
    if interpret and mode != "on":
        raise ValueError("interpret=True applies to the forced mode 'on' only")
    _mode, _interpret = mode, interpret


def choose(
    kernel: Callable,
    xla: Callable,
    *args,
    entities: int,
    ineligible: Optional[str] = None,
):
    """``kernel(*args)`` or ``xla(*args)``, by the mode.

    ``entities`` is the world's count of colliding entities; ``ineligible``
    says why the kernel cannot take these inputs (None when it can).
    ``kernel`` also accepts ``interpret=``."""
    if _mode == "off":
        return xla(*args)
    if _mode == "on":
        if ineligible is not None:
            raise ValueError(f"kernel mode 'on', but {ineligible}")
        if _interpret:
            return kernel(*args, interpret=True)
        if jax.default_backend() != "gpu":
            raise RuntimeError(
                "kernel mode 'on' needs a GPU (default backend is "
                f"{jax.default_backend()!r}); use 'auto' or 'off'"
            )
        return kernel(*args)
    if ineligible is not None or entities < MIN_ENTITIES:
        return xla(*args)
    return jax.lax.platform_dependent(*args, cuda=kernel, default=xla)
