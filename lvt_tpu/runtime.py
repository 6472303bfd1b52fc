"""Process set-up shared by the entry points (CLI, bench.py, chip_smoke.py):
the persistent compile cache and the device the process runs on. Nothing
here runs at package import."""

from __future__ import annotations

import os
import pathlib

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# a fixed path inside the checkout: the cache key includes nothing that
# moves between runs, so a later process finds what an earlier one stored
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing; otherwise the cache goes to ``<checkout>/.jax_cache``."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def device_summary() -> dict:
    """{"platform", "kind", "count"} of the default backend's devices."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """device_summary(), or SystemExit naming the device JAX found instead
    of a GPU (measurement paths never fall back to the CPU)."""
    dev = device_summary()
    if dev["platform"] != "gpu":
        raise SystemExit(
            f"no GPU found: JAX runs on {dev['platform']} "
            f"({dev['kind']}); this needs an NVIDIA GPU")
    return dev
