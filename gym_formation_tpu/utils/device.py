"""What the program runs on: JAX's device and, on a GPU, the card's name and
power limit as ``nvidia-smi`` reports them.  Every measurement carries this,
because a card set below its maximum power runs slower under load."""

from __future__ import annotations

import shutil
import subprocess

import jax


def nvidia_smi_line() -> str | None:
    """``name, power.limit`` of each card, one per line, or None."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        return None
    return out.stdout.strip() or None


def describe_device() -> dict:
    """{platform, kind, count, gpu} for the default backend; ``gpu`` is
    the first card's ``nvidia-smi`` name and power limit, or None."""
    d = jax.devices()[0]
    smi = nvidia_smi_line() if d.platform == "gpu" else None
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
        "gpu": smi.splitlines()[0] if smi else None,
    }
