"""The device a measurement ran on, for every result the benchmarks print.

A measurement path needs the GPU: device_info() raises when JAX finds
another platform, so no number is ever taken on the CPU by mistake. The
card's name and power limit come from nvidia-smi in a child process that
stays off JAX (a second JAX process would reserve the card's memory).
"""

from __future__ import annotations

import subprocess

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def smi_line() -> str:
    """Card 0's `name, power.limit` line exactly as nvidia-smi prints it."""
    out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def require_gpu():
    """JAX's devices; RuntimeError naming the platform if they are not GPUs."""
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"needs an NVIDIA GPU, but JAX's platform is {platform!r}")
    return devices


def device_info() -> dict:
    """{platform, kind, count, name, power_limit} of the GPU JAX runs on."""
    devices = require_gpu()
    name, _, power = smi_line().partition(",")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
            "name": name.strip(),
            "power_limit": power.strip()}
