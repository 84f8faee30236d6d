"""Vectorized scrambled-Halton QMC engine.

Re-derivation of the classic Gruenschloss Halton sampler used by the
reference (reference include/halton_sampler.h, include/halton_enum.h),
bit-comparable with the reference across all 256 dimensions
(halton_sampler.h:626-888):

* dimension 0 is the base-2 radical inverse computed by bit reversal
  (halton_sampler.h:1417-1432),
* dimensions 1..255 are permuted radical inverses in the first 255 odd
  primes (Faure or random digit permutations, halton_sampler.h:573-624).
  Two evaluation strategies produce the identical uint32 accumulator:
  - **arithmetic** (default for small primes, used by the renderer's hot
    path): per-digit divide/modulo with the digit permutation evaluated as
    a compare-select chain — pure vector math, no gathers.
  - **table** (large primes, cold dims): chunk-wise lookups through the
    same precomputed digit-permutation tables the reference bakes
    (halton_sampler.h:890-960).

The pixel-stratified sample enumeration (``HaltonEnum``) implements the
Gruenschloss–Raab–Keller elementary-interval construction
(halton_enum.h:34-157): the index of the i-th sample landing in pixel (x, y)
is obtained from the Chinese Remainder Theorem over the base-2 / base-3
radical inverses of the pixel coordinates.

Everything here is trace-free host setup (NumPy tables) plus pure jittable
functions of ``uint32`` index arrays — no data-dependent shapes.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


def _first_primes(n: int) -> tuple:
    ps, c = [], 2
    while len(ps) < n:
        if all(c % p for p in ps if p * p <= c):
            ps.append(c)
        c += 1
    return tuple(ps)


# All 256 primes of the reference's switch (dims 0..255, bases 2..1619,
# halton_sampler.h:626-888); dims >= 256 use PRNG fallback exactly like the
# reference falls back to rand() (halton_sampler.h:887).
PRIMES = _first_primes(256)
assert PRIMES[-1] == 1619  # the reference's largest base

MAX_QMC_DIMS = len(PRIMES)  # 256

# Largest prime evaluated arithmetically (select-chain); beyond this the
# per-digit select chain costs more than the table gathers it avoids.
ARITH_MAX_PRIME = 150

_SCALE_EPS = 0.9999998807907104  # keeps results strictly in [0,1)


def faure_permutations(max_base: int) -> list[np.ndarray | None]:
    """Faure digit permutations for every base up to ``max_base``.

    Standard recursive construction (Faure 1992; cf. halton_sampler.h:573-603):
    identity for bases 1..3; even base 2c interleaves the doubled base-c
    permutation with its doubled-plus-one copy; odd base 2c+1 re-centers the
    base-2c permutation around a fixed middle digit c.
    """
    perms: list[np.ndarray | None] = [None] * (max_base + 1)
    for k in range(1, min(3, max_base) + 1):
        perms[k] = np.arange(k, dtype=np.uint16)
    for base in range(4, max_base + 1):
        b = base // 2
        if base & 1:
            prev = perms[base - 1]
            p = np.empty(base, dtype=np.uint16)
            vals = prev + (prev >= b)
            idx = np.arange(base - 1)
            p[idx + (idx >= b)] = vals
            p[b] = b
        else:
            half = perms[b].astype(np.uint16)
            p = np.empty(base, dtype=np.uint16)
            p[:b] = 2 * half
            p[b:] = 2 * half + 1
        perms[base] = p
    return perms


def _table_digits(p: int) -> int:
    """Digits per lookup chunk: largest k with p**k <= 361 (table <= 361 ints,
    mirroring the reference's table sizing, halton_sampler.h:890-960)."""
    k = 1
    while p ** (k + 1) <= 361:
        k += 1
    return k


def _total_chunks(p: int, k: int) -> int:
    """Number of chunks: floor(D_max / k) where p**D_max fits in uint32."""
    d = 1
    while p ** (d + 1) <= 0xFFFFFFFF:
        d += 1
    return d // k


def _build_table(p: int, perm: np.ndarray, k: int) -> np.ndarray:
    """table[i] = digit-reversed, permuted value of the k-digit chunk i."""
    size = p ** k
    i = np.arange(size, dtype=np.uint64)
    out = np.zeros(size, dtype=np.uint64)
    rem = i.copy()
    for _ in range(k):
        out = out * p + perm[rem % p]
        rem //= p
    return out.astype(np.uint32)


def _reverse_bits32(x: jnp.ndarray) -> jnp.ndarray:
    """Full 32-bit reversal (halton_enum.h:136-144)."""
    x = x.astype(jnp.uint32)
    x = (x << 16) | (x >> 16)
    x = ((x & jnp.uint32(0x00FF00FF)) << 8) | ((x & jnp.uint32(0xFF00FF00)) >> 8)
    x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | ((x & jnp.uint32(0xF0F0F0F0)) >> 4)
    x = ((x & jnp.uint32(0x33333333)) << 2) | ((x & jnp.uint32(0xCCCCCCCC)) >> 2)
    x = ((x & jnp.uint32(0x55555555)) << 1) | ((x & jnp.uint32(0xAAAAAAAA)) >> 1)
    return x


def halton2(index: jnp.ndarray) -> jnp.ndarray:
    """Base-2 radical inverse via bit reversal written into a float mantissa,
    bit-matching halton_sampler.h:1417-1432."""
    rev = _reverse_bits32(index)
    bits = jnp.uint32(0x3F800000) | (rev >> 9)
    return jax.lax.bitcast_convert_type(bits, jnp.float32) - jnp.float32(1.0)


class HaltonSampler:
    """Scrambled Halton sampler over device-resident permutation tables.

    ``sample(dim, index)`` takes a *static* dimension and a uint32 index array
    and returns float32 samples in [0, 1), matching the reference's
    ``Halton_sampler::sample`` for dims 0..30.
    """

    def __init__(self, scramble: str = "faure", seed: int | None = None):
        max_base = PRIMES[-1]
        if scramble == "faure":
            perms = faure_permutations(max_base)
        elif scramble == "random":
            rng = np.random.default_rng(seed)
            perms = [None] * (max_base + 1)
            for b in range(1, max_base + 1):
                p = np.arange(b, dtype=np.uint16)
                if b > 3:
                    rng.shuffle(p)
                perms[b] = p
        elif scramble == "none":
            perms = [np.arange(b, dtype=np.uint16) for b in range(max_base + 1)]
        else:
            raise ValueError(f"unknown scramble: {scramble}")

        # Tables stay HOST-side NumPy: NumPy constants embed into the
        # jitted module directly instead of being captured device arrays.
        self._perms = perms
        self._tables: dict[int, np.ndarray] = {}
        self._meta: dict[int, tuple[int, int, float]] = {}
        for p in PRIMES[1:]:
            k = _table_digits(p)
            c = _total_chunks(p, k)
            if p > ARITH_MAX_PRIME:
                self._tables[p] = _build_table(p, perms[p], k)
            self._meta[p] = (k, c, _SCALE_EPS / float(p ** (k * c)))

    def _sample_table(self, p: int, index: jnp.ndarray) -> jnp.ndarray:
        """Chunk-wise table lookups (the reference's baked-table strategy,
        halton_sampler.h:1433-3288)."""
        k, c, scale = self._meta[p]
        table = jnp.asarray(self._tables[p])
        chunk = np.uint32(p ** k)
        acc = jnp.zeros(index.shape, dtype=jnp.uint32)
        div = index
        for i in range(c):
            digits = table[(div % chunk).astype(jnp.int32)]
            acc = acc + digits * np.uint32(p ** (k * (c - 1 - i)))
            if i + 1 < c:
                div = div // chunk
        return acc.astype(jnp.float32) * jnp.float32(scale)

    def _sample_arith(self, p: int, index: jnp.ndarray,
                      index_bits: int) -> jnp.ndarray:
        """Gather-free digit arithmetic, bit-identical to the table path.

        Computes the same uint32 accumulator the reference's chunked tables
        produce: ``acc = sum_j perm[digit_j(index)] * p^(K-1-j)`` over
        K = k*c total digits.  The permutation is a compare-select chain
        over host constants (pure VPU).  ``index_bits`` bounds the index so
        high zero digits can be folded into one exact integer multiply:
        digits beyond the bound are all 0, contributing
        ``perm[0] * (p^extra - 1)/(p - 1)`` plus a shift by p^extra.
        """
        k, c, scale = self._meta[p]
        K = k * c
        perm = self._perms[p]
        # digits actually influenced by an index < 2**index_bits
        needed = 1
        while needed < K and p ** needed < (1 << index_bits):
            needed += 1
        extra = K - needed
        pv = np.uint32(p)
        perm_consts = [np.uint32(v) for v in perm]
        acc = jnp.zeros(index.shape, dtype=jnp.uint32)
        div = index
        for j in range(needed):
            d = div % pv
            # perm[d] as a compare-select chain (d < p, tiny domain)
            pd = jnp.full(index.shape, perm_consts[0], jnp.uint32)
            for v in range(1, p):
                pd = jnp.where(d == np.uint32(v), perm_consts[v], pd)
            acc = acc * pv + pd
            if j + 1 < needed:
                div = div // pv
        if extra:
            shift = np.uint32(p ** extra)
            tail = np.uint32(int(perm[0]) * ((p ** extra - 1) // (p - 1)))
            acc = acc * shift + tail
        return acc.astype(jnp.float32) * jnp.float32(scale)

    @functools.partial(jax.jit, static_argnums=(0, 1, 3))
    def sample(self, dim: int, index: jnp.ndarray,
               index_bits: int = 32) -> jnp.ndarray:
        """QMC sample for static dimension ``dim`` at uint32 ``index``.

        ``index_bits``: static promise that every index < 2**index_bits —
        lets the arithmetic path skip digits that are provably zero.  The
        result is bit-identical for any valid bound.
        """
        if not (0 <= dim < MAX_QMC_DIMS):
            raise ValueError(
                f"dim {dim} outside QMC range [0,{MAX_QMC_DIMS}); "
                "use the PRNG fallback for deeper dims")
        index = index.astype(jnp.uint32)
        if dim == 0:
            return halton2(index)
        p = PRIMES[dim]
        if p <= ARITH_MAX_PRIME:
            return self._sample_arith(p, index, index_bits)
        return self._sample_table(p, index)


def _halton3_inverse_host(index: int, digits: int) -> int:
    r = 0
    for _ in range(digits):
        r = r * 3 + index % 3
        index //= 3
    return r


class HaltonEnum:
    """Pixel-stratified Halton index enumeration (halton_enum.h:34-157).

    For a W x H frame, precomputes a per-pixel CRT offset image so that
    ``index(i, x, y) = offset[y, x] + i * increment`` enumerates exactly the
    Halton indices whose (dim0, dim1) sample lands in pixel (x, y).
    """

    def __init__(self, width: int, height: int):
        assert width > 0 and height > 0
        self.width, self.height = width, height
        p2, w = 0, 1
        while w < width:
            p2, w = p2 + 1, w * 2
        p3, h = 0, 1
        while h < height:
            p3, h = p3 + 1, h * 3
        self.scale_x = float(w)
        self.scale_y = float(h)
        self.increment = w * h
        # multiplicative inverses via extended euclid (halton_enum.h:126-134)
        inv2 = pow(h, -1, w) if w > 1 else 0
        inv3 = pow(w, -1, h) if h > 1 else 0
        self._mx = h * inv2
        self._my = w * inv3
        self._p2, self._p3, self._w, self._h = p2, p3, w, h

        # Precompute per-pixel offsets on host (W*H uint32; tiny).
        xs = np.arange(width, dtype=np.uint64)
        # base-2 digit reversal of x over p2 digits
        hx = np.zeros_like(xs)
        rem = xs.copy()
        for _ in range(p2):
            hx = (hx << 1) | (rem & 1)
            rem >>= 1
        ys = np.arange(height, dtype=np.uint64)
        hy = np.zeros_like(ys)
        rem = ys.copy()
        for _ in range(p3):
            hy = hy * 3 + rem % 3
            rem //= 3
        off = (hx[None, :] * np.uint64(self._mx)
               + hy[:, None] * np.uint64(self._my)) % np.uint64(self.increment)
        # host NumPy, not jnp: see HaltonSampler.__init__ on lowering cost
        self.offsets = off.astype(np.uint32)  # (H, W)

    @property
    def max_samples_per_pixel(self) -> int:
        return 0xFFFFFFFF // self.increment

    def get_index(self, i: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
        """Index of the i-th sample in pixel (x, y) (halton_enum.h:106-114)."""
        off = jnp.asarray(self.offsets)[y, x]
        return (off + i.astype(jnp.uint32) * jnp.uint32(self.increment)).astype(jnp.uint32)

    def index_image(self, i) -> jnp.ndarray:
        """(H, W) indices for sample wave ``i`` across the whole frame."""
        i = jnp.asarray(i, dtype=jnp.uint32)
        return jnp.asarray(self.offsets) + i * jnp.uint32(self.increment)
