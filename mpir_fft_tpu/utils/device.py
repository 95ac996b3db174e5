"""What the measuring entry points record about the device they ran on."""

from __future__ import annotations

import os
import subprocess


def require_gpu():
    """JAX's devices, after checking that the first is a GPU: a measurement
    taken anywhere else must not be reported under a device metric."""
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"needs a GPU, but JAX's first device is {platform!r} "
            f"({devices[0].device_kind})")
    return devices


def nvidia_smi() -> str:
    """`name, power.limit` of every card, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def device_info(devices) -> dict:
    import jax

    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "nvidia_smi": nvidia_smi(),
        "jax": jax.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
