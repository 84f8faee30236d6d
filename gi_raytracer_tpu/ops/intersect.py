"""Ray-scene intersection: lockstep stackless BVH traversal over flat arrays.

The reference traverses a pointer octree recursively per ray with virtual
``Entity::intersect`` calls (reference include/raytracer.h:382-478,
octree.cpp:150-313).  Here every ray in a wavefront advances through the
same threaded BVH in lockstep (gather node -> slab test -> leaf prim tests ->
skip/descend): all control flow is a single `lax.while_loop` whose body is
pure vector math + gathers.

Primitive tests:
* Möller–Trumbore triangles (entities.h:443-490), branchless.
* analytic spheres (entities.h:60-101), tested densely outside the BVH.

Stochastic alpha: a candidate hit is *accepted* iff
``u < opacity*tex_alpha  or  IOR != 1`` (raytracer.h:455,297) with u a
counter-based hash of (ray_id, prim_id, salt) — deterministic, replayable.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..sampling.rng import hash_u01
from ..scene.types import Scene

_BIG = jnp.inf


class Hit(NamedTuple):
    t: jnp.ndarray        # (R,) hit distance (inf = miss)
    prim: jnp.ndarray     # (R,) int32: triangle id, or T + sphere id, -1 miss
    u: jnp.ndarray        # (R,) triangle barycentric u (unused for spheres)
    v: jnp.ndarray        # (R,) triangle barycentric v


def ray_triangle(ro, rd, v0, e1, e2, eps):
    """Branchless Möller–Trumbore. Broadcasts over leading dims.
    Returns (t, u, v, ok) with ok=False for parallel/outside/behind."""
    p = jnp.cross(rd, e2)
    det = jnp.sum(e1 * p, -1)
    ok = jnp.abs(det) >= eps
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tvec = ro - v0
    u = jnp.sum(tvec * p, -1) * inv_det
    q = jnp.cross(tvec, e1)
    v = jnp.sum(rd * q, -1) * inv_det
    t = jnp.sum(e2 * q, -1) * inv_det
    ok &= (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0)
    return t, u, v, ok


def ray_sphere(ro, rd, center, rad):
    """Analytic sphere test (entities.h:60-101). Returns (t, ok)."""
    oc = ro - center
    b = jnp.sum(rd * oc, -1)
    r = b * b - jnp.sum(oc * oc, -1) + rad * rad
    ok = r >= 0
    sr = jnp.sqrt(jnp.where(ok, r, 0.0))
    t1 = -b - sr
    t2 = -b + sr
    # nearest positive root (entities.h:76-83)
    t = jnp.where((t1 > 0), t1, t2)
    ok &= t > 0
    return jnp.where(ok, t, _BIG), ok


def ray_cone(ro, rd, pos, rad, height, w2l):
    """Batched analytic finite-cone test (entities.h:158-258, PBRT-style).

    ro/rd broadcast against leading cone dims; pos (…,3), rad/height (…,),
    w2l (…,3,3) world->local rotation.  Returns (t, ok); the clip test keeps
    the nearer root with local z in [0, height], falling back to the farther
    root like the reference (entities.h:225-241).
    """
    hi = jax.lax.Precision.HIGHEST
    o = jnp.einsum("...ij,...j->...i", w2l, ro - pos, precision=hi)
    d = jnp.einsum("...ij,...j->...i", w2l, rd, precision=hi)
    k = (rad / height) ** 2
    oz_h = o[..., 2] - height
    A = d[..., 0] ** 2 + d[..., 1] ** 2 - k * d[..., 2] ** 2
    B = 2.0 * (d[..., 0] * o[..., 0] + d[..., 1] * o[..., 1]
               - k * d[..., 2] * oz_h)
    C = o[..., 0] ** 2 + o[..., 1] ** 2 - k * oz_h ** 2
    disc = B * B - 4.0 * A * C
    ok = disc >= 0
    root = jnp.sqrt(jnp.where(ok, disc, 0.0))
    q = jnp.where(B < 0, -0.5 * (B - root), -0.5 * (B + root))
    # guard the degenerate divisions (A==0: ray parallel to the surface)
    safe_A = jnp.where(jnp.abs(A) < 1e-30, 1e-30, A)
    safe_q = jnp.where(jnp.abs(q) < 1e-30, 1e-30, q)
    t1 = q / safe_A
    t2 = C / safe_q
    lo = jnp.minimum(t1, t2)
    hi = jnp.maximum(t1, t2)
    ok &= hi > 0
    near = jnp.where(lo > 0, lo, hi)

    def clipped(t):
        z = o[..., 2] + d[..., 2] * t
        return (z >= 0) & (z <= height) & (t > 0)

    use_far = ~clipped(near)
    t = jnp.where(use_far, hi, near)
    ok &= clipped(t)
    return jnp.where(ok, t, _BIG), ok


def cone_attrs(cones, point, prim_local):
    """(normal, uv) at world-space hit points on cone ``prim_local``
    (entities.h:246-256).  The local-frame normal cross(dpdu, dpdv) is
    rotated back to world space — the reference returns it un-rotated, a
    latent bug its scenes never exercise (they only use coneMesh)."""
    pos = cones.pos[prim_local]
    h = cones.height[prim_local]
    w2l = cones.w2l[prim_local]
    p = jnp.einsum("...ij,...j->...i", w2l, point - pos,
                   precision=jax.lax.Precision.HIGHEST)
    phi = jnp.arctan2(p[..., 1], p[..., 0])
    phi = jnp.where(phi < 0, phi + 2 * jnp.pi, phi)
    u = phi / (2 * jnp.pi)
    v = p[..., 2] / h
    two_pi = 2 * jnp.pi
    dpdu = jnp.stack([-two_pi * p[..., 1], two_pi * p[..., 0],
                      jnp.zeros_like(u)], -1)
    omv = jnp.where(jnp.abs(1.0 - v) < 1e-9, 1e-9, 1.0 - v)
    dpdv = jnp.stack([-p[..., 0] / omv, -p[..., 1] / omv,
                      jnp.broadcast_to(h, u.shape)], -1)
    n_local = jnp.cross(dpdu, dpdv)
    nl = jnp.linalg.norm(n_local, axis=-1, keepdims=True)
    n_local = n_local / jnp.maximum(nl, 1e-30)
    n_world = jnp.einsum("...ji,...j->...i", w2l, n_local,
                         precision=jax.lax.Precision.HIGHEST)
    return n_world, jnp.stack([u, v], -1)


def _accept_prob(scene: Scene, mat_id):
    """P(candidate accepted) gate: alpha<1 materials pass stochastically
    unless refractive (IOR != 1 always accepted) — raytracer.h:455."""
    alpha = scene.materials.opacity[mat_id]
    refractive = scene.materials.ior[mat_id] != 1.0
    return jnp.where(refractive, 1.0, alpha)


def _leaf_tri_test(scene: Scene, ro, rd, node, t_best, salt, eps,
                   ray_id=None):
    """Intersect the K triangles of each ray's current leaf.
    Returns (t, prim, u, v, any_better) per ray for the best accepted hit."""
    bvh = scene.bvh
    K = bvh.leaf_size
    first = bvh.first[node]
    cnt = bvh.count[node]
    slots = first[:, None] + jnp.arange(K, dtype=jnp.int32)[None, :]
    in_leaf = jnp.arange(K, dtype=jnp.int32)[None, :] < cnt[:, None]
    pid = bvh.prim_idx[jnp.clip(slots, 0, max(bvh.prim_idx.shape[0] - 1, 0))]
    v0 = scene.tris.v0[pid]
    e1 = scene.tris.e1[pid]
    e2 = scene.tris.e2[pid]
    t, u, v, ok = ray_triangle(ro[:, None, :], rd[:, None, :], v0, e1, e2, eps)
    ok &= in_leaf & (t < t_best[:, None])
    # stochastic alpha acceptance (raytracer.h:455)
    mat = scene.tris.mat_id[pid]
    p_acc = _accept_prob(scene, mat)
    rid = (jnp.arange(ro.shape[0], dtype=jnp.uint32) if ray_id is None
           else ray_id.astype(jnp.uint32))[:, None]
    uni = hash_u01(rid, pid.astype(jnp.uint32), salt)
    ok &= (uni < p_acc) | (p_acc >= 1.0)
    tk = jnp.where(ok, t, _BIG)
    j = jnp.argmin(tk, axis=1)
    rows = jnp.arange(ro.shape[0])
    return (tk[rows, j], pid[rows, j], u[rows, j], v[rows, j],
            tk[rows, j] < t_best)


def closest_hit(scene: Scene, ro, rd, t_max=None, salt=0,
                eps: float = 1e-5, active=None,
                stop_on_first: bool = False, ray_id=None) -> Hit:
    """Nearest accepted hit along each ray (trace(), raytracer.h:382-478):
    the BVH walk over triangles, then the dense sphere and cone passes.
    Arguments as :func:`_bvh_walk`."""
    hit = _bvh_walk(scene, ro, rd, t_max, salt, eps, active, stop_on_first,
                    ray_id)
    hit = _sphere_pass(scene, ro, rd, hit, salt, active, t_max,
                       ray_id=ray_id)
    return _cone_pass(scene, ro, rd, hit, salt, active, t_max, ray_id=ray_id)


def _bvh_walk(scene: Scene, ro, rd, t_max=None, salt=0, eps: float = 1e-5,
              active=None, stop_on_first: bool = False, ray_id=None) -> Hit:
    """Nearest accepted triangle along each ray, by a lockstep threaded-BVH
    walk (t, u, v detached; a miss has prim -1 and t = t_max or inf).

    ``active``: lanes with active=False never traverse (vital inside the
    bounce scan — dead lanes otherwise carry degenerate directions that
    slab-test as hitting EVERY node and serialize the lockstep loop).
    ``stop_on_first``: any-hit semantics — a lane terminates at its first
    accepted hit (occlusion queries don't need the nearest one).
    ``ray_id``: lane-invariant ids keying the stochastic-alpha streams
    (defaults to the dispatch slot; sharded/compacted callers must pass the
    GLOBAL lane ids so results are layout-independent).
    """
    R = ro.shape[0]
    dt = ro.dtype
    n_nodes = scene.bvh.n_nodes
    t0 = jnp.full((R,), _BIG, dt) if t_max is None else jnp.broadcast_to(t_max, (R,)).astype(dt)

    tiny = jnp.asarray(1e-12, dt)
    safe_d = jnp.where(jnp.abs(rd) < tiny, jnp.where(rd < 0, -tiny, tiny), rd)
    inv_d = 1.0 / safe_d

    class St(NamedTuple):
        node: jnp.ndarray
        t: jnp.ndarray
        prim: jnp.ndarray
        u: jnp.ndarray
        v: jnp.ndarray

    start = jnp.zeros((R,), jnp.int32)
    if active is not None:
        start = jnp.where(active, start, n_nodes)
    st = St(node=start, t=t0,
            prim=jnp.full((R,), -1, jnp.int32),
            u=jnp.zeros((R,), dt), v=jnp.zeros((R,), dt))

    def cond(s):
        return jnp.any(s.node < n_nodes)

    def body(s):
        node = jnp.minimum(s.node, n_nodes - 1)
        running = s.node < n_nodes
        nmin = scene.bvh.node_min[node]
        nmax = scene.bvh.node_max[node]
        ta = (nmin - ro) * inv_d
        tb = (nmax - ro) * inv_d
        tn = jnp.max(jnp.minimum(ta, tb), -1)
        tf = jnp.min(jnp.maximum(ta, tb), -1)
        hit_box = running & (tf >= jnp.maximum(tn, 0.0)) & (tn < s.t)
        cnt = scene.bvh.count[node]
        is_leaf = cnt > 0
        do_leaf = hit_box & is_leaf

        lt, lp, lu, lv, better = _leaf_tri_test(
            scene, ro, rd, jnp.where(do_leaf, node, 0), s.t, salt, eps,
            ray_id=ray_id)
        upd = do_leaf & better
        t = jnp.where(upd, lt, s.t)
        prim = jnp.where(upd, lp, s.prim)
        u = jnp.where(upd, lu, s.u)
        v = jnp.where(upd, lv, s.v)

        nxt = jnp.where(hit_box & ~is_leaf, node + 1, scene.bvh.skip[node])
        if stop_on_first:
            nxt = jnp.where(prim >= 0, n_nodes, nxt)
        return St(jnp.where(running, nxt, s.node), t, prim, u, v)

    if scene.n_tris:  # cone/sphere-only scenes have no BVH to traverse
        st = jax.lax.while_loop(cond, body, st)
        # while_loop is not reverse-differentiable: detach the traversal
        # outputs (callers needing gradients to triangle vertices recompute
        # the winner's exact (t,u,v) outside — see trace_closest_rows)
        st = St(st.node, jax.lax.stop_gradient(st.t), st.prim,
                jax.lax.stop_gradient(st.u), jax.lax.stop_gradient(st.v))

    return Hit(st.t, jnp.where(~jnp.isfinite(st.t), -1, st.prim), st.u,
               st.v)


def any_hit(scene: Scene, ro, rd, t_limit, salt=0, eps: float = 1e-5,
            active=None, ray_id=None) -> jnp.ndarray:
    """True where something accepted occludes (0, t_limit) — visible(),
    raytracer.h:280-319.  Lanes terminate at their first accepted hit."""
    hit = closest_hit(scene, ro, rd, t_max=t_limit, salt=salt, eps=eps,
                      active=active, stop_on_first=True, ray_id=ray_id)
    return hit.prim >= 0


# --------------------------------------------------------------------------
# dense analytic passes and the differentiable trace entry points
# --------------------------------------------------------------------------

def _sphere_pass(scene: Scene, ro, rd, hit: Hit, salt, active=None,
                 t_max=None, ray_id=None) -> Hit:
    """Dense analytic-sphere closest-hit layered over a triangle Hit."""
    if not scene.n_spheres:
        return hit
    R = ro.shape[0]
    ts, ok = ray_sphere(ro[:, None, :], rd[:, None, :],
                        scene.spheres.pos[None], scene.spheres.rad[None])
    p_acc = _accept_prob(scene, scene.spheres.mat_id)[None, :]
    rid = (jnp.arange(R, dtype=jnp.uint32) if ray_id is None
           else ray_id.astype(jnp.uint32))[:, None]
    sid = (scene.n_tris
           + jnp.arange(scene.n_spheres, dtype=jnp.uint32))[None, :]
    uni = hash_u01(rid, sid, salt)
    ok &= (uni < p_acc) | (p_acc >= 1.0)
    if active is not None:
        ok &= active[:, None]
    if t_max is not None:
        ok &= ts < jnp.broadcast_to(t_max, (R,)).astype(ts.dtype)[:, None]
    ts = jnp.where(ok, ts, _BIG)
    j = jnp.argmin(ts, axis=1)
    rows = jnp.arange(R)
    tb = ts[rows, j]
    cur_t = jnp.where(hit.prim >= 0, hit.t, _BIG)
    upd = tb < cur_t
    return Hit(jnp.where(upd, tb, hit.t),
               jnp.where(upd, scene.n_tris + j.astype(jnp.int32), hit.prim),
               jnp.where(upd, 0.0, hit.u), jnp.where(upd, 0.0, hit.v))


def _cone_pass(scene: Scene, ro, rd, hit: Hit, salt, active=None,
               t_max=None, ray_id=None) -> Hit:
    """Dense analytic-cone closest-hit layered over an existing Hit (cones
    are rare; like spheres they are tested densely outside the BVH)."""
    if not scene.n_cones:
        return hit
    R = ro.shape[0]
    cn = scene.cones
    ts, ok = ray_cone(ro[:, None, :], rd[:, None, :], cn.pos[None],
                      cn.rad[None], cn.height[None], cn.w2l[None])
    p_acc = _accept_prob(scene, cn.mat_id)[None, :]
    rid = (jnp.arange(R, dtype=jnp.uint32) if ray_id is None
           else ray_id.astype(jnp.uint32))[:, None]
    cid = (scene.n_tris + scene.n_spheres
           + jnp.arange(scene.n_cones, dtype=jnp.uint32))[None, :]
    uni = hash_u01(rid, cid, salt)
    ok &= (uni < p_acc) | (p_acc >= 1.0)
    if active is not None:
        ok &= active[:, None]
    if t_max is not None:
        ok &= ts < jnp.broadcast_to(t_max, (R,)).astype(ts.dtype)[:, None]
    ts = jnp.where(ok, ts, _BIG)
    j = jnp.argmin(ts, axis=1)
    rows = jnp.arange(R)
    tb = ts[rows, j]
    cur_t = jnp.where(hit.prim >= 0, hit.t, _BIG)
    upd = tb < cur_t
    base = scene.n_tris + scene.n_spheres
    return Hit(jnp.where(upd, tb, hit.t),
               jnp.where(upd, base + j.astype(jnp.int32), hit.prim),
               jnp.where(upd, 0.0, hit.u), jnp.where(upd, 0.0, hit.v))


def intersect_backend(cfg) -> str:
    """The traversal ``cfg.intersect_backend`` asks for.  "auto" takes the
    Triton kernel where it compiles (a GPU) — measured faster than the BVH
    walk from 2k to 1M triangles on the H100 (PERF.md) — and the walk
    elsewhere."""
    b = cfg.intersect_backend
    if b == "auto":
        return "triton" if jax.default_backend() == "gpu" else "jnp"
    if b not in ("jnp", "triton"):
        raise ValueError(f"unknown intersect_backend {b!r}")
    return b


def _triangle_hit(scene: Scene, ro, rd, t_max, salt, eps, active, ray_id,
                  any_hit: bool, backend: str, tri_rows=None) -> Hit:
    """Nearest (or, with ``any_hit``, any) accepted triangle per ray by the
    chosen traversal, with the winner's exact (t, u, v) recomputed
    differentiably from ``tri_rows`` (a (T, >=9) table whose first columns
    are v0, e1, e2; default the scene's own triangle arrays).

    backend: "jnp" (the threaded-BVH walk) or "triton" (the Pallas kernel
    of :mod:`triton_trace`, GPU only)."""
    if backend == "jnp" or not scene.n_tris:
        hit = _bvh_walk(scene, ro, rd, t_max, salt, eps, active,
                        stop_on_first=any_hit, ray_id=ray_id)
    elif backend == "triton":
        from .triton_trace import triangle_query
        t, prim = triangle_query(scene, ro, rd, t_max, salt, eps, active,
                                 ray_id, any_hit=any_hit)
        miss_t = (jnp.full(t.shape, _BIG, ro.dtype) if t_max is None else
                  jnp.broadcast_to(t_max, t.shape).astype(ro.dtype))
        z = jnp.zeros(t.shape, ro.dtype)
        hit = Hit(jnp.where(prim >= 0, t.astype(ro.dtype), miss_t), prim,
                  z, z)
    else:
        raise ValueError(f"unknown intersect_backend {backend!r}")
    if any_hit or not scene.n_tris:
        return hit
    # traversal outputs are detached (reverse-diff of while_loop is
    # undefined); recompute the winner's exact (t,u,v) differentiably
    p = jnp.clip(hit.prim, 0, scene.n_tris - 1)
    if tri_rows is None:
        v0, e1, e2 = scene.tris.v0[p], scene.tris.e1[p], scene.tris.e2[p]
    else:
        r = tri_rows[p]
        v0, e1, e2 = r[:, 0:3], r[:, 3:6], r[:, 6:9]
    t, u, v, ok = ray_triangle(ro, rd, v0, e1, e2, eps)
    m = (hit.prim >= 0) & ok
    return Hit(jnp.where(m, t, hit.t), hit.prim,
               jnp.where(m, u, hit.u), jnp.where(m, v, hit.v))


def trace_closest(scene: Scene, ro, rd, t_max=None, salt=0, eps=1e-5,
                  active=None, ray_id=None, backend: str = "jnp") -> Hit:
    """Differentiable closest-hit (tris + spheres + cones)."""
    hit = _triangle_hit(scene, ro, rd, t_max, salt, eps, active, ray_id,
                        False, backend)
    hit = _sphere_pass(scene, ro, rd, hit, salt, active, t_max,
                       ray_id=ray_id)
    return _cone_pass(scene, ro, rd, hit, salt, active, t_max, ray_id=ray_id)


def trace_closest_rows(scene: Scene, rows, ro, rd, t_max=None, salt=0,
                       eps=1e-5, active=None, ray_id=None,
                       backend: str = "jnp"):
    """Closest hit PLUS the winner's packed shade row — one wide gather.

    ``rows`` is shading.build_prim_rows(scene): a (T+S+C, PR_W) table that
    carries exact-MT geometry, normals, uvs, material scalars and texture
    descriptors per primitive; the exact (t, u, v) recompute reads its
    v0/e1/e2 from the same table.
    Returns (Hit, row (R, PR_W)).
    """
    P = rows.shape[0]
    hit = _triangle_hit(scene, ro, rd, t_max, salt, eps, active, ray_id,
                        False, backend, tri_rows=rows)
    hit = _sphere_pass(scene, ro, rd, hit, salt, active, t_max,
                       ray_id=ray_id)
    hit = _cone_pass(scene, ro, rd, hit, salt, active, t_max, ray_id=ray_id)
    return hit, rows[jnp.clip(hit.prim, 0, P - 1)]


def trace_any(scene: Scene, ro, rd, t_limit, salt=0, eps=1e-5,
              active=None, ray_id=None, backend: str = "jnp") -> jnp.ndarray:
    """True where something accepted occludes (0, t_limit) — visible(),
    raytracer.h:280-319."""
    hit = _triangle_hit(scene, ro, rd, t_limit, salt, eps, active, ray_id,
                        True, backend)
    hit = _sphere_pass(scene, ro, rd, hit, salt, active, t_limit,
                       ray_id=ray_id)
    hit = _cone_pass(scene, ro, rd, hit, salt, active, t_limit,
                     ray_id=ray_id)
    return hit.prim >= 0


def closest_hit_brute(scene: Scene, ro, rd, t_max=None, salt=0,
                      eps: float = 1e-5, active=None, ray_id=None,
                      block: int = 2048) -> Hit:
    """Plain reference for :func:`closest_hit`: every ray against every
    triangle (no BVH), then the same dense sphere and cone passes and the
    same stochastic-alpha acceptance.  Rays are processed ``block`` at a
    time to bound the (block, T) intermediates."""
    R = ro.shape[0]
    dt = ro.dtype
    tl = (jnp.full((R,), _BIG, dt) if t_max is None
          else jnp.broadcast_to(t_max, (R,)).astype(dt))
    act = jnp.ones((R,), bool) if active is None else active
    rid = (jnp.arange(R, dtype=jnp.uint32) if ray_id is None
           else ray_id.astype(jnp.uint32))
    hit = Hit(tl, jnp.full((R,), -1, jnp.int32), jnp.zeros((R,), dt),
              jnp.zeros((R,), dt))
    if scene.n_tris:
        tr = scene.tris
        pid = jnp.arange(scene.n_tris, dtype=jnp.uint32)
        p_acc = _accept_prob(scene, tr.mat_id)[None, :]
        B = min(block, R)
        pad = (-R) % B

        def blk(xs):
            o, d, tb, a, r = xs
            t, u, v, ok = ray_triangle(o[:, None, :], d[:, None, :],
                                       tr.v0[None], tr.e1[None],
                                       tr.e2[None], eps)
            uni = hash_u01(r[:, None], pid[None, :], salt)
            ok &= ((uni < p_acc) | (p_acc >= 1.0)) & a[:, None]
            ok &= t < tb[:, None]
            tk = jnp.where(ok, t, _BIG)
            j = jnp.argmin(tk, axis=1)
            rows = jnp.arange(o.shape[0])
            found = tk[rows, j] < _BIG
            return (jnp.where(found, tk[rows, j], tb),
                    jnp.where(found, j.astype(jnp.int32), -1),
                    jnp.where(found, u[rows, j], 0.0),
                    jnp.where(found, v[rows, j], 0.0))

        def split(x):
            x = jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
            return x.reshape((-1, B) + x.shape[1:])

        out = jax.lax.map(blk, (split(ro), split(rd), split(tl), split(act),
                                split(rid)))
        hit = Hit(*(x.reshape((-1,) + x.shape[2:])[:R] for x in out))
    hit = _sphere_pass(scene, ro, rd, hit, salt, act, t_max, ray_id=rid)
    return _cone_pass(scene, ro, rd, hit, salt, act, t_max, ray_id=rid)
