"""Photon-mapped caustics: emission wavefront, hash-grid map, kNN estimate.

The reference emits photons serially per slot with up to 500 retries
(reference include/raytracer.h:582-715), stores them in a second octree
(photonMap.cpp) and estimates caustic radiance as the classic Jensen density
estimate over the k=32 nearest photons of the containing leaf
(raytracer.h:532-579).  Wavefront redesign:

* emission is a wavefront: all slots emit at once; a slot's retries become
  masked re-emission *waves* (raytracer.h:602's retry loop, vectorized);
  the specular-continuation bounce chain is a `lax.scan` of length
  photon_depth with closest-hit traversal per step;
* the map is a uniform hash grid: photons sorted by cell id, cell ranges by
  `searchsorted`; replaces the photon octree (photonMap.cpp:137-192);
* the kNN gather reads a fixed 3x3x3 cell window (bounded candidates per
  cell), masks, and `top_k`s by squared distance — a strict superset of the
  reference's single-leaf gather, validated against the *estimate*;
* the estimate  sum(col_i * dot(dir_i, d)) / (pi * r_k^2)  (raytracer.h:
  558-576) is differentiable: gradients flow through photon colors and
  positions back to light and material parameters.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import struct

from ..config import RenderConfig
from ..ops.intersect import intersect_backend, trace_closest
from ..sampling.halton import HaltonSampler
from ..sampling.rng import Purpose, stream
from ..scene.types import Scene
from .geom import normalize, random_unit_vec, sphere_cap_cos, PI
from .shading import hit_attributes_uv, material_lookup, secondary_ray


@struct.dataclass
class PhotonMap:
    pos: jnp.ndarray         # (P,3) cell-sorted
    dir: jnp.ndarray         # (P,3)
    col: jnp.ndarray         # (P,3)
    valid: jnp.ndarray       # (P,)
    cell_start: jnp.ndarray  # (C+1,) int32 prefix ranges into sorted arrays
    grid_min: jnp.ndarray    # (3,)
    inv_cell: jnp.ndarray    # (3,) 1/cell_size
    order: jnp.ndarray = None  # (P,) int32 batch->sorted permutation
    dims: tuple = struct.static_field(default=(1, 1, 1))
    window_cap: int = struct.static_field(default=8)

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    def rebind(self, batch: "PhotonBatch") -> "PhotonMap":
        """Re-attach a (differentiably re-traced) PhotonBatch to this map's
        FROZEN spatial structure (cells, sort order, window cap).  The
        acceleration structure is detached — the standard detached-sampling
        estimator — while photon positions/directions/colors carry
        gradients back to light and material parameters."""
        return self.replace(pos=batch.pos[self.order],
                            dir=batch.dir[self.order],
                            col=batch.col[self.order],
                            valid=batch.stored[self.order])


class PhotonBatch(NamedTuple):
    pos: jnp.ndarray
    dir: jnp.ndarray
    col: jnp.ndarray
    stored: jnp.ndarray


def _emit_attempts(scene: Scene, cfg: RenderConfig, sampler: HaltonSampler,
                   li: int, h_idx: jnp.ndarray, key,
                   active=None, salt=0, slot_ids=None,
                   total_count=None) -> PhotonBatch:
    """Emission attempts for light ``li`` — one lane per slot.

    The reference's serial per-slot retry loop (raytracer.h:602) becomes
    masked re-emission *rounds* in the caller; ``active`` marks the slots
    still retrying this round (already-stored slots never traverse).  Emission point/cone per light.h:47-53 +
    raytracer.h:604-618; the specular-continuation chain per
    raytracer.h:633-695.
    """
    R = h_idx.shape[0]
    dt = scene.lights.pos.dtype
    lpos = scene.lights.pos[li]
    lcol = scene.lights.col[li]
    lrad = scene.lights.rad[li]
    ldir = scene.lights.dir[li]
    langle = scene.lights.angle[li]

    sx = sampler.sample(0, h_idx).astype(dt)
    sy = sampler.sample(1, h_idx).astype(dt)

    # surface point within the caustic cone (light.h:47-53)
    cap = sphere_cap_cos(jnp.broadcast_to(ldir, (R, 3)), sx, sy, 1.0, langle)
    sphere_pt = random_unit_vec(sx, sy)
    surf = jnp.where(langle < 1.0, cap, sphere_pt)
    pos = lpos[None, :] + lrad * surf

    ku = stream(key, int(Purpose.PHOTON_EMIT_X), li)
    u = jax.random.uniform(ku, (2, R), dt)
    emit_dir = sphere_cap_cos(normalize(pos - lpos[None, :]), u[0], u[1],
                              2.0, langle)

    # emission weight = 1/count * 0.5 * angle * light color (raytracer.h:618)
    # where count is the ACTUAL number of emission slots this pass, not the
    # config default — sharded/truncated passes stay correctly normalized
    n_emit = total_count if total_count is not None else cfg.photons
    col0 = (0.5 * langle / n_emit) * lcol
    col = jnp.broadcast_to(col0, (R, 3)).astype(dt)

    # --- specular continuation chain ---------------------------------------
    ro, rd = pos, emit_dir
    salt0 = (jnp.uint32((li + 1) * 40503)
             + jnp.asarray(salt).astype(jnp.uint32) * jnp.uint32(2654435761))
    if active is None:
        active = jnp.ones(R, bool)
    # stochastic-alpha accept streams key on GLOBAL slot ids so sharding /
    # chunk slicing reproduces identical photons (intersect.py contract)
    rid = slot_ids if slot_ids is not None else jnp.arange(R, dtype=jnp.int32)

    backend = intersect_backend(cfg)
    hit = trace_closest(scene, ro, rd, salt=salt0, eps=cfg.epsilon,
                        active=active, ray_id=rid, backend=backend)
    attrs = hit_attributes_uv(scene, ro, rd, hit.t, hit.prim, hit.u, hit.v)
    _, _, _, rough, _ = material_lookup(scene, attrs.mat_id, attrs.uv)
    # only specular-first paths matter
    alive = active & attrs.valid & (rough < 0.1)

    class Chain(NamedTuple):
        ro: jnp.ndarray
        rd: jnp.ndarray
        col: jnp.ndarray
        alive: jnp.ndarray
        stored: jnp.ndarray
        p_pos: jnp.ndarray
        p_dir: jnp.ndarray
        p_col: jnp.ndarray

    st = Chain(ro, rd, col, alive,
               jnp.zeros(R, bool), jnp.zeros((R, 3), dt),
               jnp.zeros((R, 3), dt), jnp.zeros((R, 3), dt))

    def body(s: Chain, depth):
        salt = salt0 + (depth.astype(jnp.uint32) + 1) * jnp.uint32(7919)
        kb = jax.random.fold_in(stream(key, int(Purpose.PHOTON_ALPHA), li),
                                depth)
        uni = jax.random.uniform(kb, (4, R), dt)

        hit = trace_closest(scene, s.ro, s.rd, salt=salt, eps=cfg.epsilon,
                            active=s.alive, ray_id=rid, backend=backend)
        attrs = hit_attributes_uv(scene, s.ro, s.rd, hit.t, hit.prim,
                                  hit.u, hit.v)
        color, _, alpha, rough, ior = material_lookup(scene, attrs.mat_id,
                                                      attrs.uv)
        sec = secondary_ray(s.rd, attrs.normal, color, alpha, rough, ior,
                            uni[0], uni[1], uni[2], uni[3],
                            jnp.ones((R, 3), dt))
        live = s.alive & attrs.valid
        new_col = jnp.where(live[:, None], s.col * sec.f, s.col)
        new_ro = attrs.point + (sec.offset_sign * cfg.shadow_bias)[:, None] \
            * sec.normal
        new_rd = sec.dir

        # first diffuse hit after the specular chain stores the photon
        # (raytracer.h:685-692): position = hit, direction = the bounced
        # diffuse-sampled dir, color including the diffuse surface's f.
        store_now = live & (rough >= 0.1) & ~s.stored
        keep_going = live & (rough < 0.1)

        return Chain(
            jnp.where(live[:, None], new_ro, s.ro),
            jnp.where(live[:, None], new_rd, s.rd),
            new_col,
            keep_going,
            s.stored | store_now,
            jnp.where(store_now[:, None], attrs.point, s.p_pos),
            jnp.where(store_now[:, None], new_rd, s.p_dir),
            jnp.where(store_now[:, None], new_col, s.p_col),
        ), None

    st, _ = jax.lax.scan(body, st, jnp.arange(cfg.photon_depth))
    return PhotonBatch(st.p_pos, st.p_dir, st.p_col, st.stored)


def _emit_chunk(scene, key, start, li=0, n_slots=1, *, cfg, sampler,
                differentiable=False, total_count=None):
    """First-success emission for slots [start, start+n_slots) of light li,
    retrying failed slots up to cfg.photon_retries ROUNDS (the reference's
    serial 500-retry loop, raytracer.h:602, as a while_loop that exits as
    soon as every slot stored).

    ``differentiable``: run the rounds as a fixed-length `lax.scan` (no
    early exit) so the whole emission is reverse-differentiable — gradients
    flow from stored photon colors back to light/material parameters."""
    retries = max(cfg.photon_retries, 1)
    dt = scene.lights.pos.dtype
    slot = start + jnp.arange(n_slots, dtype=jnp.uint32)

    class Rt(NamedTuple):
        rnd: jnp.ndarray
        pos: jnp.ndarray
        dir: jnp.ndarray
        col: jnp.ndarray
        stored: jnp.ndarray

    st0 = Rt(jnp.uint32(0),
             jnp.zeros((n_slots, 3), dt), jnp.zeros((n_slots, 3), dt),
             jnp.zeros((n_slots, 3), dt), jnp.zeros(n_slots, bool))

    def cond(st):
        return (st.rnd < retries) & jnp.any(~st.stored)

    def body(st):
        # Halton layout slot*retries + round: the reference's
        # i*500+tries indexing scheme (raytracer.h:604)
        h_idx = slot * jnp.uint32(retries) + st.rnd
        kr = jax.random.fold_in(key, st.rnd)
        wave = _emit_attempts(scene, cfg, sampler, li, h_idx, kr,
                              active=~st.stored, salt=st.rnd,
                              slot_ids=slot.astype(jnp.int32),
                              total_count=total_count)
        new = wave.stored & ~st.stored
        return Rt(st.rnd + 1,
                  jnp.where(new[:, None], wave.pos, st.pos),
                  jnp.where(new[:, None], wave.dir, st.dir),
                  jnp.where(new[:, None], wave.col, st.col),
                  st.stored | new)

    if differentiable:
        st, _ = jax.lax.scan(lambda c, _: (body(c), None), st0,
                             None, length=retries)
    else:
        st = jax.lax.while_loop(cond, body, st0)
    return PhotonBatch(st.pos, st.dir, st.col, st.stored)


def trace_photons(scene: Scene, cfg: RenderConfig,
                  sampler: HaltonSampler | None = None,
                  key=None, count: int | None = None,
                  differentiable: bool = False) -> PhotonBatch:
    """Emit ``count`` photon slots per light with masked retry rounds.
    Returns fixed-size per-slot arrays (stored = success mask).

    The reference retries each emission slot serially up to 500 times until
    it stores a photon (raytracer.h:602).  Here that loop is a
    `lax.while_loop` over *rounds*: every round re-emits only the slots that
    have not stored yet (compacted, so resolved slots cost nothing) and
    stops as soon as every slot succeeded — identical first-success
    semantics, one compile, O(count) memory independent of the retry cap.
    """
    sampler = sampler or HaltonSampler()
    key = key if key is not None else jax.random.PRNGKey(cfg.seed)
    count = count or cfg.photons
    L = scene.lights.count
    dt = scene.lights.pos.dtype
    if L == 0:
        return PhotonBatch(jnp.zeros((1, 3), dt), jnp.zeros((1, 3), dt),
                           jnp.zeros((1, 3), dt), jnp.zeros(1, bool))

    retries = max(cfg.photon_retries, 1)
    slots_per_chunk = min(max(cfg.ray_chunk, 1), count)

    run_chunk = jax.jit(
        functools.partial(_emit_chunk, cfg=cfg, sampler=sampler,
                          differentiable=differentiable, total_count=count),
        static_argnames=("li", "n_slots"))

    parts = []
    for li in range(L):
        pos_l, dir_l, col_l, st_l = [], [], [], []
        for start in range(0, count, slots_per_chunk):
            n = min(slots_per_chunk, count - start)
            kc = jax.random.fold_in(key, start // slots_per_chunk)
            b = run_chunk(scene, kc, jnp.uint32(start), li, n)
            pos_l.append(b.pos); dir_l.append(b.dir)
            col_l.append(b.col); st_l.append(b.stored)
        parts.append(PhotonBatch(jnp.concatenate(pos_l),
                                 jnp.concatenate(dir_l),
                                 jnp.concatenate(col_l),
                                 jnp.concatenate(st_l)))
    return PhotonBatch(
        jnp.concatenate([p.pos for p in parts]),
        jnp.concatenate([p.dir for p in parts]),
        jnp.concatenate([p.col for p in parts]),
        jnp.concatenate([p.stored for p in parts]))


def build_photon_map(batch: PhotonBatch, world_min, world_max,
                     target_per_cell: float = 4.0,
                     max_dim: int = 1024, window_cap: int | None = None,
                     window_cap_max: int = 96,
                     max_cells: int = 33_554_432) -> PhotonMap:
    # NOTE on sizing: cells must stay COARSE enough that the 3x3x3 gather
    # window covers the k-NN radius (window reach = 1.5 cells); occupancy
    # ~4-8/cell with cap up to 96 is the validated operating point —
    # refining further shrinks the window below r_k and the estimate loses
    # true neighbors (measured: oracle mismatch at target_per_cell=2)
    """Sort photons into a uniform grid (replaces photonMap.cpp:137-192).

    world_min/world_max: host-side floats (grid geometry must be static);
    the grid itself is fitted to the STORED-photon bounding box (slightly
    padded) like the reference's photon octree root, and its per-axis
    resolution follows the photon extent — a planar caustic sheet (the
    common case: photons are stored on 2-D surfaces, raytracer.h:685-692)
    gets a thin axis with few cells and fine in-plane cells, instead of
    wasting the max_dim budget cubically.  Refinement doubles resolution
    until the densest cell fits the gather window or ``max_cells`` is
    reached — the uniform-grid analogue of the reference octree's
    subdivide-to-<=16/leaf rule (photonMap.cpp:137-192, util.h:15).

    ``window_cap`` (candidates gathered per window cell) defaults to the
    MEASURED maximum cell occupancy, clamped to ``window_cap_max`` — so on
    typical maps the 3x3x3 gather window truncates nothing and the kNN
    estimate matches the brute-force oracle; only pathologically dense
    focal cells (occupancy > window_cap_max) are clipped, where r_k is tiny
    and the clipped tail is far outside the k-nearest set.
    """
    P = batch.pos.shape[0]
    n_stored = max(int(jnp.sum(batch.stored)), 1)
    dt = batch.pos.dtype

    # photon bbox (host): queries outside clip into the boundary cells,
    # exactly the reference's getBounds clamp (photonMap.cpp:115-134)
    stored_np = np.asarray(batch.stored)
    pos_np = np.asarray(batch.pos, np.float64)
    if stored_np.any():
        pmin = pos_np[stored_np].min(0)
        pmax = pos_np[stored_np].max(0)
    else:
        pmin = np.asarray(world_min, np.float64)
        pmax = np.asarray(world_max, np.float64)
    span = np.maximum(pmax - pmin, 0.0)
    pad_w = np.maximum(span.max() * 1e-3, 1e-6)
    wmin = pmin - pad_w
    extent = np.maximum(span + 2 * pad_w, 1e-6)

    # common cell size h; per-axis counts follow the extent (thin axes get
    # few cells).  Initial h from the occupied-volume heuristic.
    n_cells_target = max(n_stored / target_per_cell, 1.0)
    h = float((np.prod(extent) / n_cells_target) ** (1 / 3))

    def dims_of(h):
        d = np.clip(np.ceil(extent / h).astype(np.int64), 1, max_dim)
        return tuple(int(x) for x in d)

    def cell_ids(h):
        dims = dims_of(h)
        inv_cell = np.asarray(dims) / extent
        gi = ((batch.pos - jnp.asarray(wmin, dt)) * jnp.asarray(inv_cell, dt))
        gi = jnp.clip(gi.astype(jnp.int32), 0,
                      jnp.asarray(np.asarray(dims) - 1, jnp.int32))
        cid = (gi[:, 0] * dims[1] + gi[:, 1]) * dims[2] + gi[:, 2]
        C = dims[0] * dims[1] * dims[2]
        return jnp.where(batch.stored, cid, C), dims, inv_cell, C

    # refine until the densest cell fits the gather window (photons cluster
    # at caustic foci, so the initial count-based heuristic can leave cells
    # holding hundreds of photons — the exact bias the reference's adaptive
    # photon octree avoids by splitting to <=16/leaf, photonMap.cpp:137-192)
    if window_cap is None:
        prev = None
        while True:
            cid, dims, inv_cell, C = cell_ids(h)
            occ_max = int(jnp.max(jnp.bincount(
                jnp.where(cid < C, cid, 0),
                weights=(cid < C).astype(jnp.int32), length=C)))
            if occ_max <= window_cap_max:
                break
            if prev is not None and occ_max >= prev[1]:
                # refinement stopped helping (photons coincident at this
                # scale) — undo the useless doubling and accept truncation
                h = prev[0]
                cid, dims, inv_cell, C = cell_ids(h)
                break
            nxt = dims_of(h / 2)
            if (np.prod(np.asarray(nxt, np.int64)) > max_cells
                    or nxt == dims):
                break
            prev = (h, occ_max)
            h = h / 2
        window_cap = int(np.clip(occ_max, 1, window_cap_max))
    else:
        cid, dims, inv_cell, C = cell_ids(h)
    cell_id = cid

    order = jnp.argsort(cell_id)
    sorted_id = cell_id[order]
    cell_start = jnp.searchsorted(sorted_id,
                                  jnp.arange(C + 1, dtype=jnp.int32),
                                  side="left").astype(jnp.int32)

    return PhotonMap(pos=batch.pos[order], dir=batch.dir[order],
                     col=batch.col[order], valid=batch.stored[order],
                     cell_start=cell_start,
                     grid_min=jnp.asarray(wmin, dt),
                     inv_cell=jnp.asarray(inv_cell, dt),
                     order=order.astype(jnp.int32),
                     dims=dims, window_cap=window_cap)


def _window_occupancy(pm: PhotonMap, point) -> jnp.ndarray:
    """(R,) photon count over each point's 3x3x3 cell window — 54 cheap
    int gathers; edge-clamp duplicates overcount (conservative)."""
    nx, ny, nz = pm.dims
    g = (point - pm.grid_min[None, :]) * pm.inv_cell[None, :]
    gi = jnp.clip(g.astype(jnp.int32), 0,
                  jnp.asarray([nx - 1, ny - 1, nz - 1], jnp.int32))
    total = jnp.zeros(point.shape[0], jnp.int32)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                cx = jnp.clip(gi[:, 0] + ox, 0, nx - 1)
                cy = jnp.clip(gi[:, 1] + oy, 0, ny - 1)
                cz = jnp.clip(gi[:, 2] + oz, 0, nz - 1)
                cid = (cx * ny + cy) * nz + cz
                total = total + (pm.cell_start[cid + 1] - pm.cell_start[cid])
    return total


def sample_photons(pm: PhotonMap, point: jnp.ndarray, direction: jnp.ndarray,
                   k: int, lane_chunk: int | None = None) -> jnp.ndarray:
    """Jensen caustic estimate at shading points (raytracer.h:532-579).

    Gathers candidates from the 3x3x3 cell window around each point (up to
    ``window_cap`` per cell), takes the k nearest, and returns
    sum(col_i * dot(dir_i, direction)) / (pi * r_k^2).

    Caustic photons CLUSTER (that is the point of them), so most shading
    points see an EMPTY window; a cheap occupancy pre-pass compacts the
    occupied lanes to the front and the expensive candidate gather + top-k
    runs only on as many ``lane_chunk`` blocks as occupied lanes fill —
    empty-window lanes return exactly 0, the reference's empty-leaf result
    (photonMap.cpp:50-66).  Differentiable throughout (scan + cond, no
    while_loop).
    """
    R = point.shape[0]
    if lane_chunk is None:
        # bound the (B, 27*cap) candidate intermediates to ~16M entries
        # (x3 coords x4 bytes ≈ 200 MB peak) — big windows OOM'd the device
        # at a fixed 32k block
        window = 27 * max(int(pm.window_cap), 1)
        lane_chunk = int(np.clip(2 ** int(np.log2(
            max(16_777_216 // window, 1024))), 1024, 32768))
    B = min(lane_chunk, max(R, 1))
    pad = (-R) % B
    n_blk = (R + pad) // B

    occ = _window_occupancy(pm, point)
    nonzero = occ > 0
    a = nonzero.astype(jnp.int32)
    n_occ = jnp.sum(a)
    c_t = jnp.cumsum(a) - a
    c_f = jnp.cumsum(1 - a) - (1 - a)
    dest = jnp.where(nonzero, c_t, n_occ + c_f)   # stable occupied-first

    def put(x):
        y = jnp.zeros_like(x).at[dest].set(x, unique_indices=True)
        return jnp.pad(y, ((0, pad), (0, 0)))

    pts = put(point)
    dirs = put(direction)
    blocks_needed = (n_occ + B - 1) // B

    def step(_, xs):
        b, p_b, d_b = xs
        est = jax.lax.cond(
            b < blocks_needed,
            # rematerialized under a gradient, like the chunk-row blocks
            lambda: jax.checkpoint(_sample_photons_block, static_argnums=(3,))(
                pm, p_b, d_b, k),
            lambda: jnp.zeros((B, 3), point.dtype))
        return None, est

    _, out = jax.lax.scan(step, None,
                          (jnp.arange(n_blk), pts.reshape(n_blk, B, 3),
                           dirs.reshape(n_blk, B, 3)))
    return out.reshape(n_blk * B, 3)[dest]


def _sample_photons_block(pm: PhotonMap, point, direction, k):
    R = point.shape[0]
    dt = point.dtype
    nx, ny, nz = pm.dims
    cap = pm.window_cap

    g = (point - pm.grid_min[None, :]) * pm.inv_cell[None, :]
    gi = jnp.clip(g.astype(jnp.int32), 0,
                  jnp.asarray([nx - 1, ny - 1, nz - 1], jnp.int32))

    cand_idx = []
    cand_ok = []
    n_true = jnp.zeros(R, jnp.int32)
    n_got = jnp.zeros(R, jnp.int32)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                cx = jnp.clip(gi[:, 0] + ox, 0, nx - 1)
                cy = jnp.clip(gi[:, 1] + oy, 0, ny - 1)
                cz = jnp.clip(gi[:, 2] + oz, 0, nz - 1)
                # skip duplicate cells at the clamp boundary
                dup = ((cx != gi[:, 0] + ox) | (cy != gi[:, 1] + oy)
                       | (cz != gi[:, 2] + oz))
                cid = (cx * ny + cy) * nz + cz
                start = pm.cell_start[cid]
                end = pm.cell_start[cid + 1]
                cnt = jnp.where(dup, 0, end - start)
                n_true = n_true + cnt
                n_got = n_got + jnp.minimum(cnt, cap)
                sl = start[:, None] + jnp.arange(cap, dtype=jnp.int32)[None, :]
                ok = (sl < end[:, None]) & ~dup[:, None]
                cand_idx.append(jnp.clip(sl, 0, pm.capacity - 1))
                cand_ok.append(ok)
    idx = jnp.concatenate(cand_idx, axis=1)     # (R, 27*cap)
    ok = jnp.concatenate(cand_ok, axis=1)

    ppos = pm.pos[idx]                           # (R, W, 3)
    d2 = jnp.sum((ppos - point[:, None, :]) ** 2, -1)
    d2 = jnp.where(ok & pm.valid[idx], d2, jnp.inf)

    k = min(k, d2.shape[1])
    neg_top, top_i = jax.lax.top_k(-d2, k)       # ascending distance
    top_d2 = -neg_top
    found = jnp.isfinite(top_d2)
    n_found = jnp.sum(found, axis=1)

    rows = jnp.arange(R)[:, None]
    sel = idx[rows, top_i]
    pcol = pm.col[sel]
    pdir = pm.dir[sel]
    w = jnp.sum(pdir * direction[:, None, :], -1)
    contrib = jnp.where(found[:, :, None], pcol * w[:, :, None], 0.0)
    total = jnp.sum(contrib, axis=1)

    # r_k^2 = squared distance of the count-th photon (raytracer.h:574)
    kth = jnp.clip(n_found - 1, 0, k - 1)
    max_d2 = top_d2[jnp.arange(R), kth]
    has = n_found > 0
    denom = jnp.where(has, PI * jnp.maximum(max_d2, 1e-20), 1.0)
    est = jnp.where(has[:, None], total / denom[:, None],
                    jnp.zeros((R, 3), dt))
    # subsample correction: when the per-cell gather cap truncated the
    # window (dense maps past the grid's max_dim resolution — e.g. 7.5M
    # planar photons leave ~1e5/cell at 192^3), the candidates are an
    # effectively-random within-cell subsample at rate p = got/true, and
    # the kNN density estimate scales by p (r_k grows by 1/sqrt(p)).
    # Dividing by p restores the density unbiasedly; exact (p == 1)
    # windows are untouched, so small-map oracle parity is unchanged.
    # The reference needs no such term — its photon octree subdivides
    # adaptively to <=16/leaf (photonMap.cpp:137-192).
    #
    # LIMITS of the correction (it preserves the mean, not the variance):
    # the r_k^2 ∝ 1/p scaling assumes SURFACE-distributed photons (2-D
    # manifolds — the only way caustic photons are stored, raytracer.h:
    # 685-692, so the production paths satisfy it).  For a volumetric
    # photon distribution r_k^2 would scale as p^(-2/3) and dividing by p
    # over-inflates by ~p^(-1/3); p is also a whole-window aggregate, not
    # per-cell.  Keep p near 1 by sizing the grid (build_photon_map
    # refines until occupancy fits the cap) rather than leaning on this
    # term.
    p_rate = jnp.where(n_true > 0,
                       n_got.astype(dt) / jnp.maximum(n_true, 1).astype(dt),
                       1.0)
    return est / jnp.maximum(p_rate, 1e-6)[:, None]


def sample_photons_backend(pm: PhotonMap, point, direction, k,
                           backend: str = "auto") -> jnp.ndarray:
    """Caustic estimate by the chosen kNN path; both compute the same
    estimator.  "jnp" is the per-point window gather
    (:func:`sample_photons`); "chunkrow" fetches each window as whole
    32-photon rows (:func:`photon_knn.sample_photons_chunkrow`).  "auto"
    takes the per-point gather, the faster of the two on the GPU."""
    if backend == "chunkrow":
        from .photon_knn import sample_photons_chunkrow
        # under a gradient, recompute the estimate in the backward pass
        # instead of keeping its candidate gathers for every bounce
        return jax.checkpoint(sample_photons_chunkrow, static_argnums=(3,))(
            pm, point, direction, k)
    if backend in ("auto", "jnp"):
        return sample_photons(pm, point, direction, k)
    raise ValueError(f"unknown knn_backend {backend!r}")


def trace_photons_sharded(scene: Scene, cfg: RenderConfig, mesh,
                          sampler: HaltonSampler | None = None,
                          key=None, count: int | None = None) -> PhotonBatch:
    """trace_photons with emission slots sharded over a device mesh.

    Each device emits its contiguous slot range (global slot ids keep the
    Halton sequence and every stochastic stream identical to the
    single-device layout when cfg.ray_chunk == count // n_devices); the
    returned PhotonBatch leaves are row-sharded — feeding them to
    build_photon_map assembles the global map (XLA all-gathers the shards),
    the SPMD form of the reference's per-thread photon buffers merged
    under omp critical (raytracer.h:587-712).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    sampler = sampler or HaltonSampler()
    key = key if key is not None else jax.random.PRNGKey(cfg.seed)
    count = count or cfg.photons
    L = scene.lights.count
    dt = scene.lights.pos.dtype
    if L == 0:
        return PhotonBatch(jnp.zeros((1, 3), dt), jnp.zeros((1, 3), dt),
                           jnp.zeros((1, 3), dt), jnp.zeros(1, bool))
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]
    if count % n_dev:
        raise ValueError(f"photon count {count} not divisible by {n_dev}")
    per = count // n_dev

    scene_specs = jax.tree_util.tree_map(lambda _: P(), scene)

    parts = []
    for li in range(L):
        def body_fn(scene, key, li=li):
            shard_i = jax.lax.axis_index(axis)
            start = shard_i.astype(jnp.uint32) * jnp.uint32(per)
            kc = jax.random.fold_in(key, shard_i)
            return _emit_chunk(scene, kc, start, li, per,
                               cfg=cfg, sampler=sampler, total_count=count)

        fn = shard_map(body_fn, mesh=mesh,
                       in_specs=(scene_specs, P()),
                       out_specs=PhotonBatch(P(axis), P(axis),
                                             P(axis), P(axis)),
                       check_vma=False)
        parts.append(jax.jit(fn)(scene, key))
    return PhotonBatch(
        jnp.concatenate([p.pos for p in parts]),
        jnp.concatenate([p.dir for p in parts]),
        jnp.concatenate([p.col for p in parts]),
        jnp.concatenate([p.stored for p in parts]))
