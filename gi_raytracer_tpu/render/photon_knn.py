"""Chunk-row kNN caustic estimate.

The per-point gather in :mod:`photon` pads every query's 27-cell window to
``27 * window_cap`` candidate slots (cap = the map's densest cell, up to
96) and `top_k`s the result.  Photons are cell-sorted with row-major cell
ids, so a query's 3x3x3 window is exactly 9 contiguous runs of the photon
array (one per in-range (x, y) column, z contiguous).  This path fetches
those runs as whole 32-photon chunk rows of a packed (P/32, 512) table,
then evaluates the same Jensen estimator (same windows, same k-th radius
semantics) with `top_k` in ordinary XLA.

It is plain differentiable jnp (gathers + top_k + arithmetic), which is
why training losses use it (``knn_backend="chunkrow"``): gradients reach
photon positions and colors, and through them light and material
parameters.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

CCAP_SMALL = 16       # small-width bucket (512 candidate slots)
CR_BLK = 8192         # lanes per block at the small width
CR_BLK_BIG = 2048     # lanes per block at the wide width


def _window_runs(pm, point):
    """Stage 1: per-query window runs -> 32-aligned disjoint chunk ranges.
    Returns (cells (B,3) i32, lo_c (B,9), prefix (B,9), n_chunks (B,)) —
    cheap (18 cell_start gathers/lane)."""
    B = point.shape[0]
    nx, ny, nz = pm.dims
    dims_i = jnp.asarray([nx - 1, ny - 1, nz - 1], jnp.int32)
    p32 = point.astype(jnp.float32)
    g = (p32 - pm.grid_min[None, :].astype(jnp.float32)) \
        * pm.inv_cell[None, :].astype(jnp.float32)
    cells = jnp.clip(g.astype(jnp.int32), 0, dims_i)

    # the 9 contiguous z-runs of the clamped 3x3x3 window (cell-id order,
    # so run starts ascend and the chunk cummax merge stays disjoint)
    starts, ends = [], []
    cx, cy, cz = cells[:, 0], cells[:, 1], cells[:, 2]
    zlo = jnp.maximum(cz - 1, 0)
    zhi = jnp.minimum(cz + 1, nz - 1)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            wx = cx + ox
            wy = cy + oy
            in_r = (wx >= 0) & (wx < nx) & (wy >= 0) & (wy < ny)
            base = (jnp.clip(wx, 0, nx - 1) * ny
                    + jnp.clip(wy, 0, ny - 1)) * nz
            s = pm.cell_start[base + zlo]
            e = pm.cell_start[base + zhi + 1]
            starts.append(jnp.where(in_r, s, 0))
            ends.append(jnp.where(in_r, e, 0))
    r_s = jnp.stack(starts, axis=1)                       # (B, 9)
    r_e = jnp.stack(ends, axis=1)
    run_ok = r_e > r_s

    # 32-aligned chunk ranges, cummax-merged so ranges stay disjoint
    as_ = r_s // 32
    ae_ = jnp.where(run_ok, -(-r_e // 32), 0)
    cmax_inc = jax.lax.associative_scan(jnp.maximum, ae_, axis=1)
    cmax_exc = jnp.concatenate(
        [jnp.zeros((B, 1), ae_.dtype), cmax_inc[:, :-1]], axis=1)
    lo_c = jnp.maximum(as_, cmax_exc)
    rlen = jnp.where(run_ok, jnp.maximum(ae_ - lo_c, 0), 0)
    prefix = jnp.cumsum(rlen, axis=1)                     # (B, 9)
    return cells, lo_c, prefix, prefix[:, -1]


def _expand_cids(lo_c, prefix, n_chunks, ccap, sentinel):
    """Stage 2: the (B, ccap) chunk-id list from the 9 merged ranges."""
    B = lo_c.shape[0]
    jj = jnp.arange(ccap, dtype=jnp.int32)[None, :]
    run_of = jnp.zeros((B, ccap), jnp.int32)
    for r in range(9):
        run_of = run_of + (jj >= prefix[:, r:r + 1]).astype(jnp.int32)
    run_of = jnp.minimum(run_of, 8)
    before = jnp.zeros((B, ccap), jnp.int32)
    startc = jnp.zeros((B, ccap), jnp.int32)
    for r in range(9):
        is_r = run_of == r
        if r > 0:
            before = jnp.where(is_r, prefix[:, r - 1:r], before)
        startc = jnp.where(is_r, lo_c[:, r:r + 1], startc)
    return jnp.where(jj < jnp.minimum(n_chunks, ccap)[:, None],
                     jnp.clip(startc + (jj - before), 0, sentinel - 1),
                     sentinel)


def _est_from_chunks(tbl, cid, cells, point, direction, k):
    """Stage 3: fetch candidate chunk ROWS and evaluate the estimator.
    Selection = every candidate within the exact k-th radius (distance
    ties included).  Differentiable (gathers + top_k + arithmetic)."""
    B, ccap = cid.shape
    p32 = point.astype(jnp.float32)
    cand = tbl[cid].reshape(B, ccap * 32, 16)             # the row fetch
    qc = cells.astype(jnp.float32)
    ok = ((jnp.abs(cand[:, :, 9] - qc[:, 0:1]) <= 1.0)
          & (jnp.abs(cand[:, :, 10] - qc[:, 1:2]) <= 1.0)
          & (jnp.abs(cand[:, :, 11] - qc[:, 2:3]) <= 1.0))
    # NaN-sentinel positions already fail the membership mask; they must
    # ALSO be scrubbed before the arithmetic, or the masked branch's NaN
    # poisons the query-point gradient through where()'s 0 * NaN chain
    psafe = jnp.where(jnp.isnan(cand[:, :, 0:3]), 0.0, cand[:, :, 0:3])
    d2 = jnp.sum((psafe - p32[:, None, :]) ** 2, -1)
    d2 = jnp.where(ok, d2, jnp.inf)

    kk = min(k, d2.shape[1])
    neg_top, _ = jax.lax.top_k(-d2, kk)                   # ascending
    top_d2 = -neg_top
    found = jnp.isfinite(top_d2)
    n_found = jnp.sum(found, axis=1)

    kth = jnp.clip(n_found - 1, 0, kk - 1)
    max_d2 = top_d2[jnp.arange(B), kth]
    sel = d2 <= max_d2[:, None]
    w = jnp.sum(cand[:, :, 3:6]
                * direction.astype(jnp.float32)[:, None, :], -1)
    contrib = jnp.where(sel[:, :, None], cand[:, :, 6:9] * w[:, :, None],
                        0.0)
    total = jnp.sum(contrib, axis=1)

    has = n_found > 0
    denom = jnp.where(has, jnp.float32(np.pi)
                      * jnp.maximum(max_d2, 1e-20), 1.0)
    return jnp.where(has[:, None], total / denom[:, None], 0.0)


def sample_photons_chunkrow(pm, point, direction, k, ccap=96):
    """Differentiable chunk-row kNN estimate: per-query window candidates
    fetched as whole 32-photon chunk rows, then top_k + Jensen in ordinary
    XLA.  Lanes are WIDTH-BUCKETED by their chunk count — most windows fit
    CCAP_SMALL chunks and pay a 6x smaller fetch — and each bucket
    processes only as many fixed-size blocks as its population fills.
    Windows past ``ccap`` chunks (denser than the occupancy-driven grid
    could resolve — bitwise-coincident foci) fall back per-lane to
    photon.sample_photons (its per-cell-cap truncation + subsample
    correction included)."""
    from .photon import sample_photons

    R = point.shape[0]
    dt = point.dtype
    tbl = _pack_chunk_table(pm)
    sentinel = tbl.shape[0] - 1
    cells, lo_c, prefix, n_chunks = _window_runs(pm, point)
    overflow = n_chunks > ccap

    est = jnp.zeros((R + 1, 3), jnp.float32)
    buckets = (
        ((n_chunks > 0) & (n_chunks <= CCAP_SMALL), CCAP_SMALL, CR_BLK),
        ((n_chunks > CCAP_SMALL) & ~overflow, ccap, CR_BLK_BIG),
    )
    for mask, W, blk in buckets:
        blk = min(blk, max(R, 1))
        a = mask.astype(jnp.int32)
        n_c = jnp.sum(a)
        c = jnp.cumsum(a) - a
        slot = jnp.where(mask, c, R)
        ids = jnp.full((R + 1,), 0, jnp.int32).at[
            jnp.minimum(slot, R)].set(jnp.arange(R, dtype=jnp.int32))[:R]
        n_blk = -(-R // blk)

        def step(est, i, ids=ids, n_c=n_c, W=W, blk=blk):
            t0 = jnp.minimum(i * blk, R - blk)

            def computed():
                lanes = jax.lax.dynamic_slice(ids, (t0,), (blk,))
                live = (t0 + jnp.arange(blk, dtype=jnp.int32)) < n_c
                cid = _expand_cids(lo_c[lanes], prefix[lanes],
                                   n_chunks[lanes], W, sentinel)
                # rematerialized in the backward pass: stored, each
                # block's (blk, W * 32, 16) candidate fetch would be kept
                # for every block of every bounce
                e = jax.checkpoint(_est_from_chunks, static_argnums=(5,))(
                    tbl, cid, cells[lanes], point[lanes], direction[lanes], k)
                return est.at[jnp.where(live, lanes, R)].set(e)

            return jax.lax.cond(t0 < n_c, computed, lambda: est), None

        est, _ = jax.lax.scan(step, est, jnp.arange(n_blk))

    est = est[:R].astype(dt)

    def slow():
        far = (pm.grid_min - 1e6 * jnp.maximum(
            1.0 / jnp.maximum(pm.inv_cell, 1e-20), 1.0)).astype(dt)
        p_slow = jnp.where(overflow[:, None], point, far[None, :])
        return sample_photons(pm, p_slow, direction, k)

    est_slow = jax.lax.cond(
        jnp.any(overflow), slow, lambda: jnp.zeros((R, 3), dt))
    return jnp.where(overflow[:, None], est_slow, est)


def _pack_chunk_table(pm):
    """(P32 + 1, 512) f32: photon rows [pos, dir, col, cell xyz, pad]
    grouped 32 to a chunk row; invalid photons and padding carry NaN
    positions AND NaN cell coords (they then fail every cell-membership
    compare).  The final row is the all-NaN sentinel chunk that padded
    chunk ids point at.

    Cell coords (cols 9-11) are computed here in the MAP dtype with the
    exact truncation build_photon_map uses — the estimator compares against
    these instead of recomputing floor() in f32, so a photon on a cell
    boundary can never be fetched via the map's runs yet fail the
    membership mask."""
    P = pm.pos.shape[0]
    nan = jnp.float32(jnp.nan)
    nx, ny, nz = pm.dims
    dims_i = jnp.asarray([nx - 1, ny - 1, nz - 1], jnp.int32)
    g = (pm.pos - pm.grid_min[None, :]) * pm.inv_cell[None, :]
    cells = jnp.clip(g.astype(jnp.int32), 0, dims_i).astype(jnp.float32)
    cells = jnp.where(pm.valid[:, None], cells, nan)
    pos = jnp.where(pm.valid[:, None], pm.pos.astype(jnp.float32), nan)
    rows = jnp.concatenate([
        pos, pm.dir.astype(jnp.float32), pm.col.astype(jnp.float32),
        cells, jnp.zeros((P, 4), jnp.float32)], axis=1)   # (P, 16)
    pad = (-P) % 32
    rows = jnp.pad(rows, ((0, pad + 32), (0, 0)))
    rows = rows.at[P:, 0:3].set(nan)
    rows = rows.at[P:, 9:12].set(nan)
    return rows.reshape(-1, 512)                           # (P32 + 1, 512)
