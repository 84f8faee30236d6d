"""Low-discrepancy scalar/vector sequences beyond the Halton engine.

Vectorized re-designs of the reference's misc samplers (reference
include/util.cpp:108-162, include/util.h:162-188):

* ``radical_inverse_vdc``  — base-2 Van-der-Corput bit reversal
  (util.h:162-170), vectorized over uint32 arrays.
* ``hammersley2d``         — (i/N, VdC(i)) point set (util.cpp:13-17).
* ``subrand``              — additive-recurrence (sqrt-prime mod 1)
  sequence (util.cpp:109-126).  The reference draws the stride from a
  random prime and the start from drand(); here both are explicit
  arguments so sequences are reproducible and jit-safe.
* ``subrand_unit_vec``     — the reference's "subrandom unit vectors"
  (util.cpp:129-155) which, in the active code path, are uniform sphere
  points driven by the Hammersley set; used to precompute area-light
  surface points (light.h:18-29).
* ``importance_sample_ggx`` — GGX (phi, theta) importance sample
  (util.cpp:157-162); vestigial in the reference but part of its public
  sampler surface.

All functions are pure jnp, differentiable where meaningful, and accept
arbitrary leading batch shapes.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..render.geom import PI

SUBRAND_PRIMES = jnp.asarray([2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31],
                             jnp.float32)


def radical_inverse_vdc(bits: jnp.ndarray) -> jnp.ndarray:
    """Base-2 radical inverse by bit reversal (util.h:162-170)."""
    b = bits.astype(jnp.uint32)
    b = (b << 16) | (b >> 16)
    b = ((b & jnp.uint32(0x55555555)) << 1) | ((b & jnp.uint32(0xAAAAAAAA)) >> 1)
    b = ((b & jnp.uint32(0x33333333)) << 2) | ((b & jnp.uint32(0xCCCCCCCC)) >> 2)
    b = ((b & jnp.uint32(0x0F0F0F0F)) << 4) | ((b & jnp.uint32(0xF0F0F0F0)) >> 4)
    b = ((b & jnp.uint32(0x00FF00FF)) << 8) | ((b & jnp.uint32(0xFF00FF00)) >> 8)
    return b.astype(jnp.float64 if False else jnp.float32) * jnp.float32(
        2.3283064365386963e-10)


def hammersley2d(i: jnp.ndarray, n: int) -> jnp.ndarray:
    """(..., 2) Hammersley points (i/N, VdC(i)) (util.cpp:13-17)."""
    i = jnp.asarray(i)
    x = i.astype(jnp.float32) / jnp.float32(n)
    y = radical_inverse_vdc(i)
    return jnp.stack([x, y], axis=-1)


def subrand(n: int, start: float | jnp.ndarray = 0.0,
            prime_index: int = 0) -> jnp.ndarray:
    """Additive-recurrence sequence x_i = frac(start + (i+1)*a) with
    a = frac(sqrt(prime)) (util.cpp:109-126).  Closed form replaces the
    reference's sequential loop — same values, O(1) depth."""
    a = jnp.mod(jnp.sqrt(SUBRAND_PRIMES[prime_index % 11]), 1.0)
    i = jnp.arange(1, n + 1, dtype=jnp.float32)
    return jnp.mod(jnp.asarray(start, jnp.float32) + i * a, 1.0)


def sphere_point(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Uniform unit-sphere point from two uniforms (util.h:183-188):
    theta = acos(2y - 1), phi = 2*pi*x."""
    theta = jnp.arccos(jnp.clip(2.0 * y - 1.0, -1.0, 1.0))
    st = jnp.sin(theta)
    return jnp.stack([st * jnp.cos(2.0 * PI * x),
                      st * jnp.sin(2.0 * PI * x),
                      jnp.cos(theta)], axis=-1)


def subrand_unit_vec(n: int) -> jnp.ndarray:
    """(n, 3) low-discrepancy unit sphere points (util.cpp:129-155).
    The reference's active path drives util.h:183's mapping with the
    Hammersley set; the additive-recurrence z-channel is dead there."""
    h = hammersley2d(jnp.arange(n, dtype=jnp.uint32), n)
    return sphere_point(h[..., 0], h[..., 1])


def importance_sample_ggx(x: jnp.ndarray, y: jnp.ndarray,
                          a: jnp.ndarray) -> jnp.ndarray:
    """GGX importance sample -> (..., 2) of (phi, theta) (util.cpp:157-162)."""
    phi = 2.0 * PI * x
    theta = jnp.arccos(jnp.sqrt((1.0 - y) / ((a * a - 1.0) * y + 1.0)))
    return jnp.stack([phi, theta], axis=-1)
