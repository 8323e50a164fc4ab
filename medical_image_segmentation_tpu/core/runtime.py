"""Process set-up shared by the entry points: the persistent compile cache
and the accelerator check."""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# a fixed path inside the checkout (git ignores build/): the cache is keyed
# on its directory, so a path that moved between runs would never hit
DEFAULT_COMPILE_CACHE_DIR = os.path.join(REPO_ROOT, "build", "jax_cache")


def enable_compile_cache() -> str:
    """Give JAX a persistent compilation cache; call before the first compile.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing. Otherwise the cache goes to ``<repo>/build/jax_cache``.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE_DIR)
    return DEFAULT_COMPILE_CACHE_DIR


def require_gpu() -> list:
    """The process's devices; raises SystemExit unless JAX runs on a GPU.

    Measurement paths call this instead of falling back to the CPU: a number
    taken on the CPU must never be reported as the accelerator's."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {devices[0].platform!r} ({devices[0].device_kind})")
    return devices


def device_record() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    devices = jax.devices()
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}
