"""Closest-hit and any-hit over triangles as one Pallas kernel (Triton route).

Triangles are stored in BVH-leaf order (SceneBuilder.build), so ``CK``
consecutive triangles form a spatially compact chunk, and ``sc``
consecutive chunks a compact group.  Each kernel program owns a block of
``RB`` rays and walks a list of groups:

1. OUTSIDE the kernel (XLA): a per-ray slab test against every group's
   bounds gives, per (ray block, group), the nearest entry distance over the
   block's active rays (inf where no ray enters within its t limit); the
   groups are sorted by that entry per block.
2. INSIDE the kernel: a ``while_loop`` visits the block's groups in entry
   order while ``entry <= t_cap``, where ``t_cap`` is the farthest distance
   any active ray of the block still needs (its best hit, or its t limit).
   Every chunk of a visited group is tested against every ray of the block
   as one (RB, CK) tile; because the entries are sorted, the first group
   beyond ``t_cap`` ends the walk — a block-collective front-to-back early
   exit (the reference's octree early-out, raytracer.h:446-472).

The Möller–Trumbore test (entities.h:443-490) runs in its separable
triple-product form, so the per-(ray, triangle) work is dot products with
per-chunk features derived from (v0, e1, e2):

    det   = -(rd . n2)                  n2  = e1 x e2
    u_num =  (ro x rd) . e2 + rd . f_u  f_u = v0 x e2
    v_num = -(ro x rd) . e1 - rd . f_v  f_v = v0 x e1
    t_num =  ro . n2 - d0               d0  = v0 . n2

with all comparisons multiplied through by sign(det).  Stochastic alpha uses
the same ``hash_u01(ray id, triangle id, salt)`` stream as the BVH walk.  The
kernel returns the winning triangle per ray; exact (t, u, v) are recomputed
outside for the winner only, which is also what makes the trace
differentiable (the selection is an integer).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

RB = 32            # rays per kernel program
CK = 64            # triangles per chunk (one (RB, CK) tile)
MAX_GROUPS = 1024  # groups per scene: bounds the per-block sort
NUM_WARPS = 4
_BIG = 3.0e38
_IMAX = 2147483647


def _mix(h):
    """murmur3 finalizer, as sampling.rng._mix."""
    h ^= h >> 16
    h = h * jnp.uint32(0x85EBCA6B)
    h ^= h >> 13
    h = h * jnp.uint32(0xC2B2AE35)
    h ^= h >> 16
    return h


def _kernel(salt_ref, rays_ref, rid_ref, order_ref, entry_ref, feat_ref,
            t_ref, prim_ref, *, n_groups: int, sc: int, any_hit: bool,
            all_opaque: bool, eps: float):
    """One block of RB rays.  rays_ref (8, RB): origin xyz, direction xyz,
    t_eff (the ray's t limit, -BIG on inactive rays), pad.  order/entry
    (n_groups_pad,): this block's groups in entry order.  feat_ref
    (16, T_pad): rows v0 xyz, e1 xyz, e2 xyz, accept."""
    big = jnp.float32(_BIG)
    nbig = jnp.float32(-_BIG)
    ox, oy, oz = (rays_ref[k, :][:, None] for k in range(3))
    dx, dy, dz = (rays_ref[k, :][:, None] for k in range(3, 6))
    t_eff = rays_ref[6, :]
    act = t_eff > nbig
    # ro x rd, shared by u_num / v_num across every chunk
    cxx = oy * dz - oz * dy
    cxy = oz * dx - ox * dz
    cxz = ox * dy - oy * dx
    rid = rid_ref[...][:, None]
    salt_mix = _mix(salt_ref[0])
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, CK), 1)

    def test_chunk(c, best_t, best_p):
        base = c * CK
        sl = pl.ds(base, CK)
        v0x, v0y, v0z = (feat_ref[k, sl][None, :] for k in range(3))
        e1x, e1y, e1z = (feat_ref[k, sl][None, :] for k in range(3, 6))
        e2x, e2y, e2z = (feat_ref[k, sl][None, :] for k in range(6, 9))
        n2x = e1y * e2z - e1z * e2y
        n2y = e1z * e2x - e1x * e2z
        n2z = e1x * e2y - e1y * e2x
        fux = v0y * e2z - v0z * e2y
        fuy = v0z * e2x - v0x * e2z
        fuz = v0x * e2y - v0y * e2x
        fvx = v0y * e1z - v0z * e1y
        fvy = v0z * e1x - v0x * e1z
        fvz = v0x * e1y - v0y * e1x
        d0 = v0x * n2x + v0y * n2y + v0z * n2z

        m = dx * n2x + dy * n2y + dz * n2z           # rd . n2 = -det
        sm = jnp.where(m >= 0.0, 1.0, -1.0)
        ns = jnp.where(m >= 0.0, -1.0, 1.0)           # sign(det)
        ds = m * sm                                   # |det|
        us = ns * ((cxx * e2x + cxy * e2y + cxz * e2z)
                    + (dx * fux + dy * fuy + dz * fuz))
        vs = sm * ((cxx * e1x + cxy * e1y + cxz * e1z)
                   + (dx * fvx + dy * fvy + dz * fvz))
        ts = ns * ((ox * n2x + oy * n2y + oz * n2z) - d0)
        ok = ((ds >= eps) & (us >= 0.0) & (vs >= 0.0) & (us + vs <= ds)
              & (ts > 0.0))
        tc = ts / jnp.maximum(ds, 1e-30)
        ok &= (tc < t_eff[:, None]) & (tc < best_t[:, None])
        prim = base + lane
        if not all_opaque:
            # stochastic alpha (raytracer.h:455): sampling.rng.hash_u01
            accept = feat_ref[9, sl][None, :]
            h = _mix(rid * jnp.uint32(0x9E3779B9)
                     ^ _mix(prim.astype(jnp.uint32) + jnp.uint32(0x7F4A7C15)
                            ^ salt_mix))
            uni = ((h >> 8).astype(jnp.int32).astype(jnp.float32)
                   * jnp.float32(5.960464477539063e-08))
            ok &= (uni < accept) | (accept >= 1.0)
        tt = jnp.where(ok, tc, big)
        tmin = jnp.min(tt, axis=1)
        pmin = jnp.min(jnp.where(ok & (tt <= tmin[:, None]), prim, _IMAX),
                       axis=1)
        better = tmin < best_t
        return (jnp.where(better, tmin, best_t),
                jnp.where(better, pmin, best_p))

    def t_cap_of(best_t):
        if any_hit:
            # a ray with any accepted hit needs no further traversal
            need = act & (best_t >= big)
            return jnp.max(jnp.where(need, t_eff, nbig))
        return jnp.max(jnp.where(act, jnp.minimum(best_t, t_eff), nbig))

    def cond(carry):
        # entries are sorted and groups no ray enters sort last as _BIG:
        # the first of those ends the walk even while t_cap is still _BIG
        # (a ray with no t limit and no hit yet)
        i, _, _, t_cap = carry
        e = entry_ref[jnp.minimum(i, n_groups - 1)]
        return (i < n_groups) & (e < big) & (e <= t_cap)

    def body(carry):
        i, best_t, best_p, t_cap = carry
        g = order_ref[i]

        def chunk(j, bt_bp):
            return test_chunk(g * sc + j, *bt_bp)

        best_t, best_p = jax.lax.fori_loop(0, sc, chunk, (best_t, best_p))
        return i + 1, best_t, best_p, jnp.minimum(t_cap, t_cap_of(best_t))

    init = (jnp.int32(0), jnp.full((RB,), big, jnp.float32),
            jnp.full((RB,), -1, jnp.int32),
            jnp.max(jnp.where(act, t_eff, nbig)))
    _, best_t, best_p, _ = jax.lax.while_loop(cond, body, init)
    t_ref[...] = best_t
    prim_ref[...] = jnp.where(best_t < big, best_p, -1)


def group_size(n_tris: int) -> int:
    """Chunks per group: a power of two keeping groups <= MAX_GROUPS."""
    n_chunks = max(-(-n_tris // CK), 1)
    sc = 1
    while -(-n_chunks // sc) > MAX_GROUPS:
        sc *= 2
    return sc


def tri_features(scene, sc: int):
    """(16, T_pad) f32 rows v0 xyz, e1 xyz, e2 xyz, accept and the groups'
    bounds (2, G, 3).  Padding triangles are degenerate (never hit)."""
    tr = scene.tris
    T = tr.v0.shape[0]
    span = CK * sc
    pad = (-T) % span
    accept = jnp.where(scene.materials.ior[tr.mat_id] != 1.0, 1.0,
                       scene.materials.opacity[tr.mat_id])
    cols = jnp.concatenate([tr.v0, tr.e1, tr.e2, accept[:, None]],
                           axis=1).astype(jnp.float32)          # (T, 10)
    feat = jnp.pad(cols, ((0, pad), (0, 6))).T                   # (16, T_pad)
    v = jnp.stack([tr.v0, tr.v0 + tr.e1, tr.v0 + tr.e2], 1)     # (T, 3, 3)
    lo = jnp.pad(jnp.min(v, 1), ((0, pad), (0, 0)), constant_values=_BIG)
    hi = jnp.pad(jnp.max(v, 1), ((0, pad), (0, 0)), constant_values=-_BIG)
    G = (T + pad) // span
    bounds = jnp.stack([jnp.min(lo.reshape(G, span, 3), 1),
                        jnp.max(hi.reshape(G, span, 3), 1)])
    return jax.lax.stop_gradient(feat), jax.lax.stop_gradient(
        bounds.astype(jnp.float32))


def _group_order(bounds, ro, rd, t_eff):
    """Per ray block: groups in ascending nearest-entry order, and the
    sorted entries (inf-like where no active ray of the block enters)."""
    lo, hi = bounds[0], bounds[1]                                # (G, 3)
    tiny = jnp.float32(1e-12)
    safe = jnp.where(jnp.abs(rd) < tiny, jnp.where(rd < 0, -tiny, tiny), rd)
    inv = 1.0 / safe
    tn = jnp.full((ro.shape[0], lo.shape[0]), -_BIG, jnp.float32)
    tf = jnp.full((ro.shape[0], lo.shape[0]), _BIG, jnp.float32)
    for ax in range(3):
        ta = (lo[None, :, ax] - ro[:, None, ax]) * inv[:, None, ax]
        tb = (hi[None, :, ax] - ro[:, None, ax]) * inv[:, None, ax]
        tn = jnp.maximum(tn, jnp.minimum(ta, tb))
        tf = jnp.minimum(tf, jnp.maximum(ta, tb))
    ent = jnp.maximum(tn, 0.0)
    score = jnp.where((tf >= ent) & (ent <= t_eff[:, None]), ent, _BIG)
    score = jnp.min(score.reshape(-1, RB, lo.shape[0]), axis=1)
    order = jnp.argsort(score, axis=1).astype(jnp.int32)
    return order, jnp.take_along_axis(score, order, axis=1)


@functools.partial(jax.jit, static_argnames=(
    "sc", "any_hit", "all_opaque", "eps", "interpret"))
def _trace(feat, bounds, ro, rd, t_eff, rid, salt, *, sc, any_hit,
           all_opaque, eps, interpret):
    R = ro.shape[0]
    n_blocks = R // RB
    G = bounds.shape[1]
    order, entry = _group_order(bounds, ro, rd, t_eff)
    rays = jnp.concatenate([ro.T, rd.T, t_eff[None, :],
                            jnp.zeros((1, R), jnp.float32)], axis=0)
    kernel = functools.partial(_kernel, n_groups=G, sc=sc, any_hit=any_hit,
                               all_opaque=all_opaque, eps=eps)
    t, prim = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[
            pl.BlockSpec((1,), lambda i: (0,)),
            pl.BlockSpec((8, RB), lambda i: (0, i)),
            pl.BlockSpec((RB,), lambda i: (i,)),
            pl.BlockSpec((None, G), lambda i: (i, 0)),
            pl.BlockSpec((None, G), lambda i: (i, 0)),
            pl.BlockSpec(feat.shape, lambda i: (0, 0)),
        ],
        out_specs=[pl.BlockSpec((RB,), lambda i: (i,)),
                   pl.BlockSpec((RB,), lambda i: (i,))],
        out_shape=[jax.ShapeDtypeStruct((R,), jnp.float32),
                   jax.ShapeDtypeStruct((R,), jnp.int32)],
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=2),
        backend="triton",
        interpret=interpret,
        name="tri_trace",
    )(salt, rays, rid, order, entry, feat)
    return t, prim


def triangle_query(scene, ro, rd, t_max=None, salt=0, eps=1e-5,
                   active=None, ray_id=None, any_hit=False,
                   interpret=False):
    """(approx t (R,), prim (R,)) of the nearest accepted triangle per ray
    (prim -1 = miss; with ``any_hit`` any accepted triangle within
    ``t_max``).  Selection only: exact values are the caller's job.
    ``interpret`` runs the kernel in the Pallas interpreter (CPU tests)."""
    R = ro.shape[0]
    pad = (-R) % RB
    f32 = jnp.float32
    sc = group_size(scene.n_tris)
    feat, bounds = tri_features(scene, sc)
    t_lim = (jnp.full((R,), _BIG, f32) if t_max is None
             else jnp.broadcast_to(t_max, (R,)).astype(f32))
    act = jnp.ones((R,), bool) if active is None else active
    t_eff = jnp.where(act, t_lim, -_BIG)
    rid = (jnp.arange(R, dtype=jnp.uint32) if ray_id is None
           else ray_id.astype(jnp.uint32))

    def padded(x, value=0):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1),
                       constant_values=value)

    ro32 = jax.lax.stop_gradient(ro).astype(f32)
    rd32 = jax.lax.stop_gradient(rd).astype(f32)
    t, prim = _trace(feat, bounds, padded(ro32), padded(rd32),
                     padded(jax.lax.stop_gradient(t_eff), -_BIG),
                     padded(rid), jnp.asarray(salt, jnp.uint32).reshape(1),
                     sc=sc, any_hit=any_hit, all_opaque=scene.all_opaque,
                     eps=float(eps), interpret=interpret)
    return t[:R], prim[:R]
