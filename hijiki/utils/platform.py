"""The one place the program decides which JAX platform it runs on.

The sync and wavefront drivers are plain XLA and run the same code on every
backend, so the platform matters in three places only: the CLI pins one
before the backend initializes (``pin_platform``), measurement paths demand a
GPU and fail without one (``require_gpu``), and the compile cache stays off
on the CPU (utils/cache.py asks ``jax.default_backend()``).
"""

from __future__ import annotations

import os

PLATFORMS = ("cpu", "gpu")


def pin_platform(name: str | None) -> None:
    """Select the JAX platform before any backend initializes: ``name``, else
    an explicit ``JAX_PLATFORMS``, else jax's own choice."""
    name = name or os.environ.get("JAX_PLATFORMS")
    if not name:
        return
    os.environ["JAX_PLATFORMS"] = name
    import jax

    jax.config.update("jax_platforms", name)


def device_summary() -> dict:
    """Platform, device kind and count of the devices jax will use, in the
    form every result line carries."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def require_gpu() -> dict:
    """``device_summary()``, or RuntimeError when jax finds no GPU. A
    measurement must fail without the card, never fall back to the CPU."""
    summary = device_summary()
    if summary["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: jax runs on {summary['platform']} ({summary['kind']})"
        )
    return summary


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the cards, one per line (the
    limit bounds the clocks a card holds under load, so every time this
    program reports goes with it)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True,
        capture_output=True,
        text=True,
        timeout=60,
    )
    return out.stdout.strip()
