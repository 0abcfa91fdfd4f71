"""What a measurement ran on: JAX's view of the devices and the card's own.

Every benchmark record and the chip smoke carry this, so a number is never
read without its device (a card set below its maximum power limit runs
slower under load)."""

from __future__ import annotations

import shutil
import subprocess


def gpu_cards() -> list[str]:
    """One line per card, as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them; empty where there is no
    ``nvidia-smi``."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return []
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def describe() -> dict:
    """platform, device_kind and count as JAX reports them, plus the
    cards' name and power limit."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind,
            "count": len(devs),
            "cards": gpu_cards()}


def _memory_stats() -> dict:
    import jax

    return jax.devices()[0].memory_stats() or {}


def bytes_limit() -> int:
    """Memory the first device lets this process allocate: ``bytes_limit``
    of ``memory_stats()``; the host's physical memory for a backend that
    reports none (the CPU)."""
    import os

    stats = _memory_stats()
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def peak_bytes() -> int | None:
    """``peak_bytes_in_use`` of the first device's ``memory_stats()``; None
    where the backend reports none."""
    return _memory_stats().get("peak_bytes_in_use")
