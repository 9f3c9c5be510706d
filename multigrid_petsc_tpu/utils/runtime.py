"""Process start-up shared by the CLI, bench.py, the benchmarks and
chip_smoke.py: 64-bit mode, the persistent compile cache, and the device
report that every measurement prints."""

from __future__ import annotations

import os
import pathlib
import subprocess

import jax
import jaxlib

CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def configure() -> None:
    """Turn on x64 once, before any array exists, and keep compiled
    programs in the persistent cache: where ``JAX_COMPILATION_CACHE_DIR``
    is set JAX reads it itself and nothing is set here; otherwise the cache
    lives at the fixed in-checkout path ``CACHE_DIR`` (a path that moves
    never hits)."""
    jax.config.update("jax_enable_x64", True)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_report() -> dict:
    """platform / kind / count of the attached devices, the card's name
    and power limit, and the settings that shape compiled code.  Raises
    unless JAX runs on a GPU: a measurement never falls back to the CPU."""
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {d.platform!r}")
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(devs),
        "card": card_name_and_power_limit(),
        "jax": jax.__version__,
        "jaxlib": jaxlib.__version__,
        "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
        "compile_cache": jax.config.jax_compilation_cache_dir,
    }
