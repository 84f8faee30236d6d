"""Wavefront path-tracing integrator.

The reference estimator is a recursive megakernel (reference
include/raytracer.h:167-276) under a per-pixel adaptive sample loop
(raytracer.h:108-148).  Here it is flattened into a wavefront:

* one *wave* = one QMC sample for every pixel, traced as a flat SoA ray
  batch; the bounce recursion becomes a `lax.scan` over bounce index with an
  alive mask (Russian roulette = masked termination + throughput boost);
* the adaptive loop becomes wave-level: after each wave the per-pixel EMA
  variance (raytracer.h:136-144) decides which pixels stay active; inactive
  lanes are masked out of the update.  Wave w uses exactly the Halton index
  the reference would use for per-pixel sample w, so sample positions are
  bit-identical.
* the whole multi-wave adaptive loop runs ON DEVICE as one jitted
  `lax.while_loop` (`Renderer.render`) — zero per-wave host dispatches or
  syncs; the python-loop path survives only for progressive preview /
  checkpointing (``on_wave``).

Everything is jit-compiled and differentiable; gradients flow through the
whole estimator to scene parameters (materials, textures, lights, camera).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..ops.intersect import (intersect_backend, trace_closest_rows,
                             trace_any)
from ..sampling.halton import HaltonSampler, HaltonEnum, MAX_QMC_DIMS
from ..sampling.rng import Purpose, stream
from ..scene.types import Scene
from .camera import Camera, primary_rays
from .geom import normalize, random_unit_vec, PI
from .shading import build_prim_rows, shade_from_rows, secondary_ray
from .atmosphere import fog_override, fog_occludes


class PathState(NamedTuple):
    ro: jnp.ndarray        # (R,3)
    rd: jnp.ndarray        # (R,3)
    throughput: jnp.ndarray  # (R,3)
    contrib: jnp.ndarray   # (R,3) Russian-roulette driver
    radiance: jnp.ndarray  # (R,3) accumulated
    alive: jnp.ndarray     # (R,)
    n_closest: jnp.ndarray  # () honest ray counters: alive closest-hit lanes
    n_shadow: jnp.ndarray   # () and issued shadow-ray lanes


def _direct_light(scene: Scene, cfg: RenderConfig, point, normal, rough,
                  u_light, salt, active=None, ray_id=None, backend="jnp"):
    """One shadow ray per light per bounce toward a uniform sphere point
    (raytracer.h:230-256).  Reference overwrites ``i`` per light (`=` not
    `+=`, raytracer.h:254); we sum — identical for the bundled single-light
    scenes, and the physically sensible generalization."""
    L = scene.lights.count
    acc = jnp.zeros_like(point)
    if L == 0:
        return acc
    bias = cfg.shadow_bias
    for li in range(L):
        lpos = scene.lights.pos[li]
        lcol = scene.lights.col[li]
        lrad = scene.lights.rad[li]
        ux, uy = u_light[2 * li], u_light[2 * li + 1]
        lp = lpos[None, :] + lrad * random_unit_vec(ux, uy)
        so = point + bias * normal
        ldir = lp - so
        max_t2 = jnp.sum(ldir * ldir, -1)
        t_lim = jnp.sqrt(max_t2) - bias
        occ = trace_any(scene, so, normalize(ldir), t_lim,
                        salt=salt + 7919 * (li + 1), active=active,
                        ray_id=ray_id, backend=backend)
        if scene.has_fog:
            occ = occ | fog_occludes(scene, cfg, so, normalize(ldir), t_lim,
                                     salt + 104729 * (li + 1),
                                     ray_id=ray_id)
        to_l = lpos[None, :] - point
        d = jnp.maximum(jnp.sum(normal * normalize(to_l), -1), 0.0)
        # pow with a masked-safe base: d==0 lanes otherwise poison the
        # d/d(roughness) gradient with 0^e * log(0) = nan
        d_pos = d > 0
        d_safe = jnp.where(d_pos, d, 1.0)
        l_term = jnp.where(d_pos,
                           d_safe ** (1.0 / jnp.maximum(rough, 1e-12)), 0.0)
        hfrac = 1.0 / (PI * jnp.sum(to_l * to_l, -1))
        acc = acc + jnp.where(occ[:, None], 0.0, lcol[None, :]
                              * (l_term * hfrac)[:, None])
    return acc


def radiance_wave(scene: Scene, cfg: RenderConfig, ro, rd,
                  sx_all, sy_all, key, wave_salt=0, photon_map=None,
                  with_counts: bool = False, lane_base=0, lane_ids=None,
                  prim_rows=None):
    """Trace a wave of rays through `max_depth` bounces; returns (R,3)
    radiance (and, with ``with_counts``, the honest per-wave traversal
    counts: alive closest-hit lanes and issued shadow-ray lanes).

    sx_all/sy_all: (D, R) per-bounce BSDF sample pairs (QMC dims 2+2d/3+2d,
    raytracer.h:172-173; PRNG beyond the sampler's 256 dims like the
    reference's rand() fallback).

    Every stochastic stream is keyed on (lane_base + lane, purpose, depth):
    callers make lane ids GLOBALLY unique per (pixel, sample) — e.g.
    lane_base = wave * n_pixels — so any slicing/batching/sharding of the
    wavefront reproduces identical decisions.  ``wave_salt`` is an extra
    constant folded into the per-bounce salt (0 for the renderer; nonzero
    callers get independent streams).
    """
    R = ro.shape[0]
    dt = ro.dtype
    D = cfg.max_depth
    backend = intersect_backend(cfg)
    ambient = jnp.asarray(cfg.ambient, dt)
    # one wide shade-row table: all per-prim attribute fetches collapse to a
    # single (R, PR_W) gather per bounce.  Callers rendering repeatedly
    # (Renderer) pass a PRECOMPUTED table: rebuilt in-loop, XLA's
    # rematerializer re-derives it per while-iteration and its (T, k<128)
    # intermediates tile-pad to 128 wide — 488 MB per temp at 1M tris
    # (measured OOM).  Gradient callers leave it None (differentiable).
    rows = prim_rows if prim_rows is not None else build_prim_rows(scene)

    state = PathState(
        ro=ro, rd=rd,
        throughput=jnp.ones((R, 3), dt),
        contrib=jnp.ones((R, 3), dt),
        radiance=jnp.zeros((R, 3), dt),
        alive=jnp.ones((R,), bool),
        n_closest=jnp.zeros((), jnp.int32),
        n_shadow=jnp.zeros((), jnp.int32),
    )

    # per-bounce decision uniforms: counter-hash keyed on (GLOBAL lane,
    # purpose, wave+depth salt) — deterministic like the threefry streams it
    # replaces (same role as drand(), raytracer.h:265,497,604) but ~10x
    # cheaper per bounce at 262k lanes.  ``lane_base`` offsets the ids when
    # this wave is a shard of a larger one, keeping every stochastic stream
    # identical to the single-device layout.
    lane_u32 = (lane_ids.astype(jnp.uint32) if lane_ids is not None
                else jnp.asarray(lane_base).astype(jnp.uint32)
                + jnp.arange(R, dtype=jnp.uint32))

    def _u(purpose, salt):
        from ..sampling.rng import hash_u01
        # high-bit tag keeps decision streams disjoint from the stochastic-
        # alpha accept streams hash_u01(ray, prim, salt) used in traversal —
        # without it a ray hitting prim p==purpose would reuse the same
        # uniform for its alpha test and its opacity/RR lottery (a
        # deterministic transport bias)
        return hash_u01(lane_u32,
                        jnp.uint32(0x80000000) ^ jnp.uint32(int(purpose)),
                        salt).astype(dt)

    def body(st: PathState, xs):
        depth, sx, sy = xs
        salt = (jnp.asarray(wave_salt).astype(jnp.uint32)
                + depth.astype(jnp.uint32) * jnp.uint32(31337))
        u_rr = _u(Purpose.RUSSIAN_ROULETTE, salt)
        u_op = _u(Purpose.RAY_TYPE_OPACITY, salt)
        u_fs = _u(Purpose.RAY_TYPE_FRESNEL, salt)
        u_light = jnp.stack(
            [_u(int(Purpose.LIGHT_POINT_X) + 16 * li + axis, salt)
             for li in range(scene.lights.count) for axis in range(2)]) \
            if scene.lights.count else jnp.zeros((0, R), dt)

        hit, row = trace_closest_rows(scene, rows, st.ro, st.rd, salt=salt,
                                      eps=cfg.epsilon, active=st.alive,
                                      ray_id=lane_u32, backend=backend)
        sh = shade_from_rows(scene, row, st.ro, st.rd, hit.t, hit.prim,
                             hit.u, hit.v)
        color, em, alpha, rough, ior = (sh.color, sh.emissive, sh.alpha,
                                        sh.rough, sh.ior)
        sec = secondary_ray(st.rd, sh.normal, color, alpha, rough, ior,
                            sx, sy, u_op, u_fs, st.contrib)
        point, normal = sh.point, sec.normal
        f, contrib, offset_sign = sec.f, sec.contrib, sec.offset_sign
        out_dir = sec.dir

        if scene.has_fog:
            (point, normal, out_dir, f, color, contrib, rough,
             offset_sign) = fog_override(
                scene, cfg, st.ro, st.rd, hit.t, sx, sy, salt,
                point, normal, out_dir, f, color, contrib, rough,
                offset_sign, ray_id=lane_u32)

        valid = st.alive & sh.valid
        i_direct = _direct_light(scene, cfg, point, normal, rough,
                                 u_light, salt, active=valid,
                                 ray_id=lane_u32, backend=backend)

        if photon_map is not None:
            from .photon import sample_photons_backend
            caustic = sample_photons_backend(photon_map, point, out_dir,
                                             cfg.knn_k, cfg.knn_backend)
            caustic = jnp.where(depth <= cfg.caustic_max_depth, caustic, 0.0)
        else:
            caustic = jnp.zeros_like(color)

        # Russian roulette (raytracer.h:263-272)
        q = jnp.max(contrib, axis=-1)
        survive = (depth <= cfg.min_depth) | (u_rr < q)
        boost = jnp.where(depth <= cfg.min_depth, 1.0,
                          1.0 / jnp.maximum(q, 1e-12))

        lum = st.radiance
        lum = lum + jnp.where(valid[:, None],
                              st.throughput * (color * i_direct), 0.0)
        lum = lum + jnp.where((valid & survive)[:, None],
                              st.throughput * (em + color * caustic), 0.0)
        lum = lum + jnp.where((st.alive & ~sh.valid)[:, None],
                              st.throughput * ambient[None, :], 0.0)

        new_T = st.throughput * f * boost[:, None]
        new_alive = valid & survive
        new_ro = point + (offset_sign * cfg.shadow_bias)[:, None] * normal
        n_closest = st.n_closest + jnp.sum(st.alive, dtype=jnp.int32)
        n_shadow = st.n_shadow + scene.lights.count * jnp.sum(
            valid, dtype=jnp.int32)
        return PathState(new_ro, out_dir, new_T, contrib, lum, new_alive,
                         n_closest, n_shadow), None

    depths = jnp.arange(D)
    state, _ = jax.lax.scan(body, state, (depths, sx_all, sy_all))
    if with_counts:
        return state.radiance, (state.n_closest, state.n_shadow)
    return state.radiance


class Renderer:
    """Frame renderer: adaptive QMC waves over the whole image."""

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig,
                 width: int, height: int, photon_map=None):
        self.scene = scene
        self.camera = camera
        self.cfg = config
        self.width, self.height = width, height
        self.sampler = HaltonSampler()
        self.enum = HaltonEnum(width, height)
        self.photon_map = photon_map
        # static bound on Halton indices this frame (wave < max_samples):
        # lets the arithmetic sampler skip provably-zero digits
        hi = self.enum.increment * max(config.max_samples, 1)
        self._index_bits = max(int(hi - 1).bit_length(), 1)
        # host NumPy key: embedded as a constant in every jitted program
        # instead of being captured as a device array
        import numpy as _np
        self._key = _np.asarray(jax.random.PRNGKey(config.seed))
        # 16x16 pixel-block ray ordering: neighbouring lanes are a compact
        # image block (a narrow frustum), so lanes that run together walk
        # similar BVH paths; the block-adaptive loop also retires whole
        # blocks.  The permutation is applied to the host-side Halton
        # offsets (free) and inverted once per wave.
        B = 16
        ids = _np.arange(height * width).reshape(height, width)
        blocks = [ids[y:y + B, x:x + B].ravel()
                  for y in range(0, height, B) for x in range(0, width, B)]
        self._perm = _np.concatenate(blocks)
        self._inv_perm = _np.argsort(self._perm).astype(_np.int32)
        # waves traced per fused-loop iteration (config.wave_size): batching
        # W waves into one W-times-wider wavefront amortizes per-iteration
        # costs; must divide max_samples so the adaptive loop's wave
        # arithmetic stays exact
        wb = max(int(config.wave_size), 1)
        ms = max(int(config.max_samples), 1)
        while ms % wb:
            wb -= 1
        self._wave_batch = wb
        self._prim_rows_cache = None

    def _prim_rows(self):
        """The packed shade-row table, computed ONCE per renderer and fed
        to every wave as a program INPUT — rebuilt inside the fused while
        loop, XLA may re-derive it on every iteration."""
        if self._prim_rows_cache is None:
            self._prim_rows_cache = jax.jit(build_prim_rows)(self.scene)
        return self._prim_rows_cache

    def _bounce_samples(self, idx_flat):
        """(D, R) QMC/PRNG pairs for every bounce (raytracer.h:172-173)."""
        cfg = self.cfg
        sx, sy = [], []
        for d in range(cfg.max_depth):
            dim_x, dim_y = 2 + 2 * d, 3 + 2 * d
            kx = stream(self._key, int(Purpose.DEEP_DIM_X), d)
            ky = stream(self._key, int(Purpose.DEEP_DIM_Y), d)
            sx.append(self.sampler.sample(dim_x, idx_flat, self._index_bits)
                      if dim_x < MAX_QMC_DIMS else
                      jax.random.uniform(kx, idx_flat.shape))
            sy.append(self.sampler.sample(dim_y, idx_flat, self._index_bits)
                      if dim_y < MAX_QMC_DIMS else
                      jax.random.uniform(ky, idx_flat.shape))
        dt = jnp.float64 if self.cfg.dtype == "float64" else jnp.float32
        return (jnp.stack(sx).astype(dt), jnp.stack(sy).astype(dt))

    def _wave_radiance(self, scene, photon_map, idx_flat, wave_i,
                       with_counts=False, prim_rows=None):
        """One full-frame sample wave -> (H*W, 3) radiance in RASTER order.

        ``idx_flat`` is raster-order per-pixel Halton indices; rays are
        traced in 16x16-block order (idx permuted host-side when static) and
        the radiance is un-permuted before returning (one (R,3) gather)."""
        import numpy as _np
        dt = jnp.float64 if self.cfg.dtype == "float64" else jnp.float32
        idx_blk = idx_flat[jnp.asarray(self._perm, jnp.int32)] \
            if not isinstance(idx_flat, _np.ndarray) else idx_flat[self._perm]
        idx_blk = jnp.asarray(idx_blk)
        xr = self.sampler.sample(0, idx_blk, self._index_bits).astype(dt)
        yr = self.sampler.sample(1, idx_blk, self._index_bits).astype(dt)
        dx = xr * self.enum.scale_x
        dy = yr * self.enum.scale_y
        ro, rd = primary_rays(self.camera, self.width, self.height, dx, dy)
        sx_all, sy_all = self._bounce_samples(idx_blk)
        key = jax.random.fold_in(self._key, wave_i)
        N = self.width * self.height
        # lane ids globally unique per (pixel, sample): wave w pixel p gets
        # id w*N + p — slicing, batching and sharding all reproduce the
        # exact same stochastic streams
        out = radiance_wave(scene, self.cfg, ro, rd, sx_all, sy_all,
                            key, 0, photon_map,
                            with_counts=with_counts,
                            lane_base=jnp.asarray(wave_i).astype(jnp.uint32)
                            * jnp.uint32(N), prim_rows=prim_rows)
        inv = jnp.asarray(self._inv_perm)
        if with_counts:
            c, counts = out
            return c[inv], counts
        return out[inv]

    @functools.partial(jax.jit, static_argnums=0)
    def _wave(self, scene, photon_map, idx_flat, wave_i, prim_rows=None):
        """One full-frame sample wave -> (H*W, 3) radiance."""
        return self._wave_radiance(scene, photon_map, idx_flat, wave_i,
                                   prim_rows=prim_rows)

    @functools.partial(jax.jit, static_argnums=0)
    def _wave_counted(self, scene, photon_map, idx_flat, wave_i,
                      prim_rows=None):
        """Like _wave but also returns the honest (closest, shadow) ray
        counts so the host-stepped loop can track state["rays"]."""
        return self._wave_radiance(scene, photon_map, idx_flat, wave_i,
                                   with_counts=True, prim_rows=prim_rows)

    @functools.partial(jax.jit, static_argnums=0)
    def _wave_inputs(self, idx_flat, wave_i):
        """Block-ordered per-lane wave inputs (rays + QMC samples) — the
        cheap prefix of a wave, split out so fog waves can dispatch the
        EXPENSIVE part (trace + raymarch) in bounded lane chunks."""
        dt = jnp.float64 if self.cfg.dtype == "float64" else jnp.float32
        idx_blk = idx_flat[jnp.asarray(self._perm, jnp.int32)]
        xr = self.sampler.sample(0, idx_blk, self._index_bits).astype(dt)
        yr = self.sampler.sample(1, idx_blk, self._index_bits).astype(dt)
        ro, rd = primary_rays(self.camera, self.width, self.height,
                              xr * self.enum.scale_x,
                              yr * self.enum.scale_y)
        sx_all, sy_all = self._bounce_samples(idx_blk)
        return ro, rd, sx_all, sy_all

    @functools.partial(jax.jit, static_argnums=0)
    def _wave_chunk(self, scene, photon_map, ro, rd, sx, sy, lane_ids,
                    wave_i, prim_rows=None):
        key = jax.random.fold_in(self._key, wave_i)
        return radiance_wave(scene, self.cfg, ro, rd, sx, sy, key, 0,
                             photon_map, with_counts=True,
                             lane_ids=lane_ids, prim_rows=prim_rows)

    def _wave_counted_chunked(self, scene, photon_map, idx_flat, wave_i,
                              chunk):
        """One wave as ceil(R/chunk) SEQUENTIAL device dispatches — each
        bounds the live (lanes x raymarch steps) working set of a fog wave.
        Lane ids are global, so results are bitwise-identical to the
        single-dispatch wave."""
        N = self.width * self.height
        ro, rd, sx_all, sy_all = self._wave_inputs(idx_flat, wave_i)
        base = int(wave_i) * N
        outs, n_c, n_s = [], 0, 0
        for s in range(0, N, chunk):
            e = min(s + chunk, N)
            lane_ids = (jnp.uint32(base)
                        + jnp.arange(s, e, dtype=jnp.uint32))
            c, (nc, ns) = self._wave_chunk(
                scene, photon_map, ro[s:e], rd[s:e],
                sx_all[:, s:e], sy_all[:, s:e], lane_ids,
                jnp.uint32(wave_i), prim_rows=self._prim_rows())
            outs.append(c)
            n_c += int(nc)
            n_s += int(ns)
        out = jnp.concatenate(outs, axis=0)
        inv = jnp.asarray(self._inv_perm)
        return out[inv], (jnp.int32(n_c), jnp.int32(n_s))

    def state0(self):
        """Fresh accumulation state (the reference's per-pixel running
        mean/EMA-variance/sample counters, raytracer.h:100-148, as images)."""
        H, W = self.height, self.width
        dt = jnp.float64 if self.cfg.dtype == "float64" else jnp.float32
        return {
            "mean": jnp.full((H, W, 3), 0.5, dt),  # raytracer.h:102 init
            "var": jnp.zeros((H, W), dt),
            "samps": jnp.zeros((H, W), jnp.int32),
            "active": jnp.ones((H, W), bool),
            "wave": jnp.zeros((), jnp.int32),
            # honest traversal count; float32 so huge renders can't overflow
            "rays": jnp.zeros((), jnp.float32),
        }

    def _accumulate(self, st, c, s):
        """One adaptive-sampling update (raytracer.h:131-148), traceable."""
        cfg = self.cfg
        mean, var = st["mean"], st["var"]
        samps, active = st["samps"], st["active"]
        prev = mean
        new_mean = jnp.where(s == 0, c, (s * mean + c) / (s + 1.0))
        mean = jnp.where(active[..., None], new_mean, mean)
        dv = jnp.linalg.norm(new_mean - prev, axis=-1)
        var = jnp.where((s > 0) & active, (5.0 * var + dv) / 6.0, var)
        extend = (s > 0) & (var > cfg.noise_thresh)
        samps = jnp.where(active, samps + 1 - 2 * extend, samps)
        active = active & (samps < cfg.min_samples)
        return {"mean": mean, "var": var, "samps": samps, "active": active,
                "wave": jnp.asarray(s + 1, jnp.int32), "rays": st["rays"]}

    def _batched_radiance(self, scene, photon_map, first_wave,
                          prim_rows=None):
        """Trace waves [first_wave, first_wave + B) as ONE (B*N)-lane
        wavefront.  Lane ids are globally unique per (pixel, sample)
        (lane_base = first_wave * N), so every stochastic stream — and
        therefore the returned radiance — is identical to B separate
        unbatched waves.  Returns ((B, H, W, 3) raster radiance, counts)."""
        import numpy as _np
        B = self._wave_batch
        H, W = self.height, self.width
        N = H * W
        dt = jnp.float64 if self.cfg.dtype == "float64" else jnp.float32
        offsets = jnp.asarray(_np.asarray(self.enum.offsets)).ravel()
        inc = jnp.uint32(self.enum.increment)
        perm = jnp.asarray(self._perm, jnp.int32)
        waves = (jnp.asarray(first_wave).astype(jnp.uint32)
                 + jnp.arange(B, dtype=jnp.uint32))
        idx = (offsets[None, :] + waves[:, None] * inc)[:, perm].ravel()
        xr = self.sampler.sample(0, idx, self._index_bits).astype(dt)
        yr = self.sampler.sample(1, idx, self._index_bits).astype(dt)
        ro, rd = primary_rays(self.camera, W, H,
                              xr * self.enum.scale_x,
                              yr * self.enum.scale_y)
        sx_all, sy_all = self._bounce_samples(idx)
        key = jax.random.fold_in(self._key, jnp.asarray(first_wave))
        base = jnp.asarray(first_wave).astype(jnp.uint32) * jnp.uint32(N)
        out, counts = radiance_wave(scene, self.cfg, ro, rd, sx_all, sy_all,
                                    key, 0, photon_map, with_counts=True,
                                    lane_base=base, prim_rows=prim_rows)
        inv = jnp.asarray(self._inv_perm)
        c = out.reshape(B, N, 3)[:, inv, :].reshape(B, H, W, 3)
        return c, counts

    def _block_adaptive_wave(self, scene, photon_map, st,
                             prim_rows=None):
        """One adaptive wave that traces ONLY the 16x16 pixel blocks still
        active (the reference stops per-PIXEL work, raytracer.h:108-148;
        dense SPMD stops per-BLOCK): active blocks are compacted to the
        front and processed in fixed-size groups, groups past the active
        count skipped — converged regions cost nothing, and the honest ray
        counters shrink accordingly."""
        import numpy as _np
        H, W = self.height, self.width
        N = H * W
        n_blocks = N // 256
        # blocks per group: <=32k lanes, >=8 groups so skipping has
        # granularity even on small frames
        G = max(min(128, n_blocks // 8), 1)
        n_groups = -(-n_blocks // G)
        dt = jnp.float64 if self.cfg.dtype == "float64" else jnp.float32
        offsets = jnp.asarray(_np.asarray(self.enum.offsets)).ravel()
        inc = jnp.uint32(self.enum.increment)
        perm = jnp.asarray(self._perm, jnp.int32)
        s = st["wave"]

        # block activity in trace (block-major) order
        act_blk = jnp.any(st["active"].reshape(H // 16, 16, W // 16, 16),
                          axis=(1, 3)).ravel()
        order = jnp.argsort(~act_blk, stable=True).astype(jnp.int32)
        n_act = jnp.sum(act_blk.astype(jnp.int32))
        groups_needed = -(-n_act // G)

        idx_all = (offsets + s.astype(jnp.uint32) * inc)[perm]
        idx_blocks = idx_all.reshape(n_blocks, 256)
        base = s.astype(jnp.uint32) * jnp.uint32(N)
        key = jax.random.fold_in(self._key, s)

        def group(g, blk_ids):
            idx = idx_blocks[blk_ids].reshape(G * 256)
            lane_ids = (base + blk_ids[:, None].astype(jnp.uint32) * 256
                        + jnp.arange(256, dtype=jnp.uint32)[None, :]
                        ).reshape(G * 256)
            xr = self.sampler.sample(0, idx, self._index_bits).astype(dt)
            yr = self.sampler.sample(1, idx, self._index_bits).astype(dt)
            ro, rd = primary_rays(self.camera, W, H,
                                  xr * self.enum.scale_x,
                                  yr * self.enum.scale_y)
            sx_all, sy_all = self._bounce_samples(idx)
            return radiance_wave(scene, self.cfg, ro, rd, sx_all, sy_all,
                                 key, 0, photon_map, with_counts=True,
                                 lane_ids=lane_ids, prim_rows=prim_rows)

        def step(carry, g):
            c_blocks, rays = carry
            blk_ids = jax.lax.dynamic_slice(order, (g * G,), (G,))
            # scatter ONLY inside the computed branch: when n_blocks % G != 0
            # the dynamic_slice clamps the last group's start, so a skipped
            # group re-slices block ids already computed by the previous
            # group — an unconditional .at[blk_ids].set would overwrite
            # their radiance with zeros (silent darkening)
            def computed():
                out, (n_c, n_s) = group(g, blk_ids)
                return (c_blocks.at[blk_ids].set(out.reshape(G, 256, 3)),
                        (n_c + n_s).astype(jnp.float32))

            c_blocks, r_inc = jax.lax.cond(
                g < groups_needed, computed,
                lambda: (c_blocks, jnp.float32(0.0)))
            return (c_blocks, rays + r_inc), None

        c0 = jnp.zeros((n_blocks, 256, 3), dt)
        (c_blocks, rays_inc), _ = jax.lax.scan(
            step, (c0, jnp.float32(0.0)), jnp.arange(n_groups))
        inv = jnp.asarray(self._inv_perm)
        c = c_blocks.reshape(N, 3)[inv].reshape(H, W, 3)
        st = self._accumulate(st, c, s)
        st["rays"] = st["rays"] + rays_inc
        return st

    @functools.partial(jax.jit, static_argnums=0)
    def _render_fused(self, scene, photon_map, state, prim_rows):
        """The ENTIRE adaptive multi-wave render as one on-device
        `lax.while_loop` — replaces the reference's per-pixel sample loop
        + OpenMP row fan-out (raytracer.h:93-148) with zero host round
        trips.  Fixed-spp renders trace `wave_size` QMC waves per
        iteration as one wide wavefront (bitwise-identical to
        one-wave-at-a-time); adaptive renders instead skip converged 16x16
        blocks entirely (`_block_adaptive_wave`)."""
        B = self._wave_batch
        adaptive = (self.cfg.adaptive
                    and self.cfg.max_samples > self.cfg.min_samples
                    and (self.height * self.width) % 256 == 0
                    and self.height % 16 == 0 and self.width % 16 == 0)

        def cond(st):
            return (st["wave"] < self.cfg.max_samples) & jnp.any(st["active"])

        def body_adaptive(st):
            return self._block_adaptive_wave(scene, photon_map, st,
                                             prim_rows=prim_rows)

        def body_batched(st):
            s = st["wave"]
            c, (n_c, n_s) = self._batched_radiance(scene, photon_map, s,
                                                   prim_rows=prim_rows)

            def fold(st_i, xs):
                cb, b = xs
                st2 = self._accumulate(st_i, cb, s + b)
                # a resume from a wave index not divisible by B can push
                # the batch past max_samples: those trailing waves must not
                # touch the accumulator
                keep = (s + b) < self.cfg.max_samples
                return jax.tree_util.tree_map(
                    lambda a, b_: jnp.where(keep, b_, a), st_i, st2), None

            st, _ = jax.lax.scan(fold, st, (c, jnp.arange(B)))
            st["rays"] = st["rays"] + (n_c + n_s).astype(jnp.float32)
            return st

        body = body_adaptive if adaptive else body_batched
        return jax.lax.while_loop(cond, body, state)

    def render(self, verbose: bool = False, on_wave=None, state=None,
               return_state: bool = False):
        """Adaptive multi-wave render -> linear (H, W, 3) mean image.

        Default path: ONE jitted on-device while_loop over waves.

        ``on_wave(state_dict, wave_index)`` is the incremental-display /
        checkpoint hook (the device-side equivalent of the reference viewer's
        32 ms repaint + progressive fill, viewer.h:16-61): called after
        every wave with the full accumulation state, which can be saved and
        passed back as ``state=`` to resume an interrupted render.  Using it
        falls back to a host-stepped wave loop.
        """
        cfg = self.cfg
        H, W = self.height, self.width
        st = state if state is not None else self.state0()
        if "rays" not in st:   # resume from an old checkpoint
            st = dict(st, rays=jnp.zeros((), jnp.float32))

        # fog frames host-step the waves and dispatch each in bounded lane
        # chunks (cfg.fog_lane_chunk): the 512-step raymarch times D bounces
        # times all lanes is otherwise one very long device program
        fog_chunked = (self.scene.has_fog and cfg.fog_lane_chunk > 0
                       and H * W > cfg.fog_lane_chunk)

        if on_wave is None and not verbose and not fog_chunked:
            st = self._render_fused(self.scene, self.photon_map, st,
                                    self._prim_rows())
            return (st["mean"], st) if return_state else st["mean"]

        first = int(st["wave"])
        for s in range(first, cfg.max_samples):
            idx = self.enum.index_image(s).ravel()
            if fog_chunked:
                c, (n_c, n_s) = self._wave_counted_chunked(
                    self.scene, self.photon_map, idx, s,
                    cfg.fog_lane_chunk)
            else:
                c, (n_c, n_s) = self._wave_counted(
                    self.scene, self.photon_map, idx, jnp.uint32(s),
                    prim_rows=self._prim_rows())
            c = c.reshape(H, W, 3)
            st = self._accumulate(st, c, jnp.asarray(s))
            st["rays"] = st["rays"] + (n_c + n_s).astype(jnp.float32)
            if verbose:
                print(f"wave {s}: active {int(st['active'].sum())}/{H * W}")
            if on_wave is not None:
                on_wave(st, s)
            if not bool(st["active"].any()):
                break
        return (st["mean"], st) if return_state else st["mean"]

    def tonemap(self, linear):
        """Gamma + clamp at the very end (raytracer.h:150-156)."""
        g = jnp.power(jnp.clip(linear, 0.0, None), 1.0 / self.cfg.gamma)
        return jnp.clip(g, 0.0, 1.0)


def render_image(scene: Scene, camera: Camera, config: RenderConfig,
                 width: int, height: int, photon_map=None, verbose=False):
    r = Renderer(scene, camera, config, width, height, photon_map)
    return r.tonemap(r.render(verbose=verbose))
