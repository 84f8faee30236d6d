"""Process set-up shared by the entry points: the persistent compile cache
and the accelerator check."""

from __future__ import annotations

import os

import jax

# fixed path inside the checkout: the cache key includes the path, so a
# directory that moves never hits
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as JAX reads it and no
    other directory is set; otherwise the cache lives in ``.jax_cache/`` at
    the root of the checkout."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def device_info() -> dict:
    """The devices JAX computes on, as every measurement line reports them."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def require_gpu() -> dict:
    """``device_info()``, or RuntimeError when JAX found no GPU: a
    measurement must not time the CPU in the card's place."""
    info = device_info()
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {jax.default_backend()!r} "
            f"({info['kind']}); this measures the card and refuses to run "
            "elsewhere")
    return info
