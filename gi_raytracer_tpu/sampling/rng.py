"""Counter-based uniform random numbers.

The reference draws from a thread-local xorshift64* generator seeded from
wall-clock time (reference include/util.h:52-80) — irreproducible by design.
Here every stochastic decision (Russian roulette, light point selection,
stochastic alpha, fog scattering, photon jitter) is keyed on *what* it is for
(ray id / primitive id / bounce / purpose), so renders are deterministic,
shardable and replayable:

* `uniform(key, shape)` — jax.random threefry streams for per-ray decisions,
  with `fold_in` chains over (wave, bounce, purpose).
* `hash_u01(a, b, c)` — a cheap integer-mix hash for per-(ray, primitive)
  uniforms inside traversal loops where drawing from a threefry stream per
  pair would dominate the kernel.
"""

from __future__ import annotations

import enum

import jax
import jax.numpy as jnp


class Purpose(enum.IntEnum):
    """Stable stream ids for every stochastic decision in the renderer."""
    LIGHT_POINT_X = 1
    LIGHT_POINT_Y = 2
    RUSSIAN_ROULETTE = 3
    RAY_TYPE_OPACITY = 4
    RAY_TYPE_FRESNEL = 5
    ALPHA_TEST = 6
    FOG_MARCH = 7
    PHOTON_EMIT_X = 8
    PHOTON_EMIT_Y = 9
    PHOTON_ALPHA = 10
    DEEP_DIM_X = 11
    DEEP_DIM_Y = 12
    FOG_DIR_X = 13
    FOG_DIR_Y = 14


def stream(base_key: jax.Array, *ids: int) -> jax.Array:
    """Derive a key for a (wave, bounce, purpose, ...) tuple."""
    k = base_key
    for i in ids:
        k = jax.random.fold_in(k, int(i))
    return k


def _mix(h: jnp.ndarray) -> jnp.ndarray:
    """Final avalanche of murmur3 — good scalar mixing on uint32."""
    h = h.astype(jnp.uint32)
    h ^= h >> 16
    h = h * jnp.uint32(0x85EBCA6B)
    h ^= h >> 13
    h = h * jnp.uint32(0xC2B2AE35)
    h ^= h >> 16
    return h


def hash_u01(a: jnp.ndarray, b, c=0) -> jnp.ndarray:
    """Uniform in [0,1) from integer coordinates (vectorized).

    Converts via the top 24 bits through int32, so a kernel can reproduce
    every stream bit-exactly (ops.triton_trace replays the stochastic-alpha
    uniforms in-kernel)."""
    a = jnp.asarray(a, jnp.uint32)
    b = jnp.asarray(b, jnp.uint32)
    c = jnp.asarray(c, jnp.uint32)
    h = _mix(a * jnp.uint32(0x9E3779B9) ^ _mix(b + jnp.uint32(0x7F4A7C15) ^ _mix(c)))
    return ((h >> 8).astype(jnp.int32).astype(jnp.float32)
            * jnp.float32(5.960464477539063e-08))
