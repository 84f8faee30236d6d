"""Surface shading: texture lookups, hit attributes, BSDF direction logic.

Vectorized (R-lane) re-design of the reference's per-ray shading
(reference include/raytracer.h:167-379,481-506, material.h): every branch
becomes a `jnp.where` select, every ``drand()`` a caller-supplied uniform.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..scene.types import Scene, Textures, TEX_CHECKER, TEX_IMAGE
from .geom import (dot, normalize, reflect, refract_tir, hemisphere_cos,
                   sample_phong)


# --------------------------------------------------------------------------
# packed prim shade rows (v2 fast path)
#
# Per-hit attribute fetches are random gathers, and each gather is one
# pass over all lanes.  So the shade path is ONE wide gather: everything a bounce needs about the
# winning primitive — exact-MT geometry, normals, uvs, material scalars and
# both texture descriptors — packed into a single (P, 64) row table.  The
# table is built from the canonical Scene arrays inside the jitted render
# (loop-invariant, hoisted by XLA) so gradients still flow to the canonical
# leaves.  Sphere/cone rows reuse the geometry columns kind-dependently.
# --------------------------------------------------------------------------

# column layout
PR_V0 = 0        # tri v0           | sphere/cone pos
PR_E1 = 3        # tri e1           | sphere rad (col 3) | cone rad 3, h 4
PR_E2 = 6        # tri e2
PR_W2L = 5       # cone world->local rotation, row-major (cols 5:14)
PR_N0, PR_N1, PR_N2 = 9, 12, 15
PR_UV0, PR_UV1, PR_UV2 = 18, 20, 22
PR_FACEN = 24
PR_HASVN = 27
PR_ROUGH, PR_OPAC, PR_IOR = 28, 29, 30
PR_TEXD = 31     # diffuse texture descriptor (14 cols)
PR_TEXE = 45     # emissive texture descriptor (14 cols)
PR_W = 64
TEXD_W = 14
# texture descriptor sub-layout (14):
#   kind, off_hi, off_lo, width, height, has_alpha, tile_u, tile_v,
#   c0 c1 c2, d0 d1 d2
# the atlas offset is carried as two exact float halves (hi*4096 + lo):
# a single f32 column silently loses texels past 2^24 on big atlases


def _tex_descriptor(tx: Textures, tid, dt):
    """(N, 14) float descriptor rows for texture ids ``tid``."""
    return _tex_descriptor_t(tx, tid, dt).T


def _tex_descriptor_t(tx: Textures, tid, dt):
    """(14, N) TRANSPOSED descriptor — assembly happens with primitives on
    the LANE axis: a (N, k<128) temp gets its minor dim tile-padded to 128
    (64x HBM blowup at 1M prims — measured OOM), a (k, N) temp pads k to
    the next sublane multiple only."""
    return jnp.concatenate([
        tx.kind[None, tid].astype(dt),
        (tx.offset[None, tid] // 4096).astype(dt),
        (tx.offset[None, tid] % 4096).astype(dt),
        tx.width[None, tid].astype(dt),
        tx.height[None, tid].astype(dt),
        tx.has_alpha[None, tid].astype(dt),
        tx.tiles[tid].T.astype(dt),
        tx.color[tid].T.astype(dt),
        tx.color2[tid].T.astype(dt),
    ], axis=0)


def build_prim_rows(scene: Scene) -> jnp.ndarray:
    """(T + S + C, PR_W) packed shade rows for every primitive.

    Assembled TRANSPOSED (columns on the sublane axis, primitives on
    lanes) and flipped once at the end: every (N, k<128) intermediate
    would tile-pad its minor dim to 128 — a 64x HBM blowup that OOM'd
    1M-triangle scenes inside the fused render loop."""
    dt = scene.tris.v0.dtype if scene.n_tris else scene.materials.roughness.dtype
    m = scene.materials
    parts = []

    def mat_rows_t(mat_id):
        return jnp.concatenate([
            m.roughness[None, mat_id].astype(dt),
            m.opacity[None, mat_id].astype(dt),
            m.ior[None, mat_id].astype(dt),
            _tex_descriptor_t(scene.textures, m.diffuse_tex[mat_id], dt),
            _tex_descriptor_t(scene.textures, m.emissive_tex[mat_id], dt),
        ], axis=0)

    if scene.n_tris:
        tr = scene.tris
        has_vn = ((jnp.sum(tr.n0 * tr.n0, -1) > 0)
                  & (jnp.sum(tr.n1 * tr.n1, -1) > 0)
                  & (jnp.sum(tr.n2 * tr.n2, -1) > 0))
        geom = jnp.concatenate([
            tr.v0.T, tr.e1.T, tr.e2.T, tr.n0.T, tr.n1.T, tr.n2.T,
            tr.uv0.T, tr.uv1.T, tr.uv2.T, tr.face_n.T,
            has_vn[None, :].astype(dt)], axis=0)
        parts.append(jnp.concatenate([geom, mat_rows_t(tr.mat_id)], axis=0))
    if scene.n_spheres:
        sp = scene.spheres
        S = sp.count
        geom = jnp.concatenate([
            sp.pos.T, sp.rad[None, :],
            jnp.zeros((24, S), dt)], axis=0)
        parts.append(jnp.concatenate([geom, mat_rows_t(sp.mat_id)], axis=0))
    if scene.n_cones:
        cn = scene.cones
        C = cn.count
        geom = jnp.concatenate([
            cn.pos.T, cn.rad[None, :], cn.height[None, :],
            cn.w2l.reshape(C, 9).T,
            jnp.zeros((14, C), dt)], axis=0)
        parts.append(jnp.concatenate([geom, mat_rows_t(cn.mat_id)], axis=0))
    if not parts:
        parts = [jnp.zeros((28 + 3 + 2 * TEXD_W, 1), dt)]
    rows_t = jnp.concatenate(parts, axis=1)
    rows_t = jnp.pad(rows_t, ((0, PR_W - rows_t.shape[0]), (0, 0)))
    return rows_t.T


def _tex_eval_desc(scene: Scene, desc, u, v):
    """(rgb (R,3), alpha (R,)) from gathered 14-col texture descriptors.
    Same semantics as :func:`sample_texture` (material.h:39-78)."""
    kind = desc[..., 0]
    const_rgb = desc[..., 8:11]
    color2 = desc[..., 11:14]
    tlu, tlv = desc[..., 6], desc[..., 7]

    iu = jnp.trunc(u * tlu)
    iv = jnp.trunc(v * tlv)
    even_u = jnp.abs(iu) % 2.0 < 0.5
    even_v = jnp.abs(iv) % 2.0 < 0.5
    checker_rgb = jnp.where((even_u ^ even_v)[..., None], const_rgb, color2)
    rgb = jnp.where((kind == TEX_CHECKER)[..., None], checker_rgb, const_rgb)
    alpha = jnp.ones_like(u)

    if scene.has_image_tex:
        w = desc[..., 3]
        h = desc[..., 4]
        wi = jnp.maximum(w.astype(jnp.int32), 1)
        hi_ = jnp.maximum(h.astype(jnp.int32), 1)
        xi = jnp.abs(jnp.trunc(u * w * tlu).astype(jnp.int32) % wi)
        yi_raw = jnp.abs(jnp.trunc(v * h * tlv).astype(jnp.int32) % hi_)
        yi = h.astype(jnp.int32) - yi_raw - 1
        offset = (desc[..., 1].astype(jnp.int32) * 4096
                  + desc[..., 2].astype(jnp.int32))
        flat = offset + yi * w.astype(jnp.int32) + xi
        flat = jnp.clip(flat, 0, scene.textures.atlas.shape[0] - 1)
        texel = scene.textures.atlas[flat]
        is_img = kind == TEX_IMAGE
        rgb = jnp.where(is_img[..., None], texel[..., :3], rgb)
        alpha = jnp.where(is_img & (desc[..., 5] > 0.5), texel[..., 3], alpha)
    return rgb, alpha


class ShadeResult(NamedTuple):
    point: jnp.ndarray     # (R, 3)
    normal: jnp.ndarray    # (R, 3) un-flipped shading normal
    uv: jnp.ndarray        # (R, 2)
    valid: jnp.ndarray     # (R,)
    color: jnp.ndarray     # (R, 3) diffuse
    emissive: jnp.ndarray  # (R, 3)
    alpha: jnp.ndarray     # (R,)
    rough: jnp.ndarray     # (R,)
    ior: jnp.ndarray       # (R,)


def shade_from_rows(scene: Scene, row, ro, rd, t, prim, bu, bv) -> ShadeResult:
    """All per-hit shading inputs from ONE pre-gathered prim row.

    ``row`` is prim_rows[clip(prim)] for the FINAL winning primitive.
    Semantics match hit_attributes_uv + material_lookup (entities.h:480-487
    interpolation gate; material.h:84-100)."""
    valid = prim >= 0
    t_safe = jnp.where(valid, t, 0.0)
    point = ro + t_safe[:, None] * rd

    # triangle attributes from the row
    n0 = row[:, PR_N0:PR_N0 + 3]
    n1 = row[:, PR_N1:PR_N1 + 3]
    n2 = row[:, PR_N2:PR_N2 + 3]
    has_vn = row[:, PR_HASVN] > 0.5
    w0 = (1.0 - bu - bv)[:, None]
    n_interp = w0 * n0 + bu[:, None] * n1 + bv[:, None] * n2
    normal = jnp.where(has_vn[:, None], n_interp, row[:, PR_FACEN:PR_FACEN + 3])
    uv = w0 * row[:, PR_UV0:PR_UV0 + 2] + bu[:, None] * row[:, PR_UV1:PR_UV1 + 2] \
        + bv[:, None] * row[:, PR_UV2:PR_UV2 + 2]
    uv = jnp.where(has_vn[:, None], uv, jnp.zeros_like(uv))

    # sphere / cone lanes override the geometry columns kind-dependently
    if scene.n_spheres:
        is_sph = (prim >= scene.n_tris) & (prim < scene.n_tris + scene.n_spheres)
        c = row[:, PR_V0:PR_V0 + 3]
        rad = jnp.where(row[:, 3] != 0, row[:, 3], 1.0)
        sph_n = (point - c) / rad[:, None]
        d = (c - point) / rad[:, None]
        sv = 0.5 + jnp.arcsin(jnp.clip(d[:, 1], -1, 1)) / jnp.pi
        su = 0.5 + jnp.arctan2(d[:, 2], d[:, 0]) / (2 * jnp.pi)
        normal = jnp.where(is_sph[:, None], sph_n, normal)
        uv = jnp.where(is_sph[:, None], jnp.stack([su, sv], -1), uv)
    if scene.n_cones:
        base = scene.n_tris + scene.n_spheres
        is_cone = prim >= base
        cpos = row[:, PR_V0:PR_V0 + 3]
        ch = jnp.where(row[:, 4] != 0, row[:, 4], 1.0)
        w2l = row[:, PR_W2L:PR_W2L + 9].reshape(-1, 3, 3)
        cone_n, cone_uv = _cone_attrs_from(point, cpos, ch, w2l)
        normal = jnp.where(is_cone[:, None], cone_n, normal)
        uv = jnp.where(is_cone[:, None], cone_uv, uv)

    # material + textures
    rough = row[:, PR_ROUGH]
    opac = row[:, PR_OPAC]
    ior = row[:, PR_IOR]
    color, ta = _tex_eval_desc(scene, row[:, PR_TEXD:PR_TEXD + TEXD_W],
                               uv[:, 0], uv[:, 1])
    em, _ = _tex_eval_desc(scene, row[:, PR_TEXE:PR_TEXE + TEXD_W],
                           uv[:, 0], uv[:, 1])
    return ShadeResult(point, normal, uv, valid, color, em,
                       opac * ta, rough, ior)


def _cone_attrs_from(point, pos, h, w2l):
    """Cone (normal, uv) from row-sourced parameters (entities.h:246-256)."""
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


# --------------------------------------------------------------------------
# packed shade tables
#
# Per-hit attribute fetches are random gathers, one pass over the lanes
# each, so ~25 narrow gathers per bounce (one per SoA field) would each
# re-read the lane indices.  Packing the per-tri, per-material and per-texture fields into single wide tables makes each
# bounce 4 gathers.  The packs are built from the canonical Scene arrays
# inside the jitted render (cheap: one pass over T rows, hoisted out of the
# bounce scan as a loop constant) so gradients still flow to the canonical
# leaves.
# --------------------------------------------------------------------------

class ShadePack(NamedTuple):
    tri_attr: jnp.ndarray   # (T, 18): n0 n1 n2 uv0 uv1 uv2 face_n has_vn
    tri_mat: jnp.ndarray    # (T,) int32
    mat_f: jnp.ndarray      # (M, 3): roughness opacity ior
    mat_tex: jnp.ndarray    # (M, 2) int32: diffuse_tex emissive_tex
    tex_f: jnp.ndarray      # (K, 8): color color2 tiles
    tex_i: jnp.ndarray      # (K, 5) int32: kind offset width height has_alpha


def pack_shade_tables(scene: Scene) -> ShadePack:
    tr = scene.tris
    m = scene.materials
    tx = scene.textures
    has_vn = ((jnp.sum(tr.n0 * tr.n0, -1) > 0)
              & (jnp.sum(tr.n1 * tr.n1, -1) > 0)
              & (jnp.sum(tr.n2 * tr.n2, -1) > 0))
    tri_attr = jnp.concatenate([
        tr.n0, tr.n1, tr.n2, tr.uv0, tr.uv1, tr.uv2, tr.face_n,
        has_vn[:, None].astype(tr.v0.dtype)], axis=1) if tr.count else \
        jnp.zeros((0, 19), tr.v0.dtype)
    mat_f = jnp.stack([m.roughness, m.opacity, m.ior], axis=1)
    mat_tex = jnp.stack([m.diffuse_tex, m.emissive_tex], axis=1)
    tex_f = jnp.concatenate([tx.color, tx.color2, tx.tiles], axis=1)
    tex_i = jnp.stack([tx.kind, tx.offset, tx.width, tx.height,
                       tx.has_alpha.astype(jnp.int32)], axis=1)
    return ShadePack(tri_attr, tr.mat_id, mat_f, mat_tex, tex_f, tex_i)


def sample_texture_packed(scene: Scene, pack: ShadePack, tid: jnp.ndarray,
                          uv: jnp.ndarray):
    """(rgb (R,3), alpha (R,)) for texture ids ``tid`` at ``uv`` — packed
    fast path: 2 gathers (+1 atlas fetch when the scene has image textures).

    Follows material.h:39-47 (checkerboard int-cast parity) and
    material.h:63-78 (image fetch with V flip and tiling).  Image texels are
    already linear (de-gamma at load).
    """
    u, v = uv[..., 0], uv[..., 1]
    tf = pack.tex_f[tid]                     # (R, 8)
    ti = pack.tex_i[tid]                     # (R, 5)
    kind = ti[..., 0]
    const_rgb = tf[..., 0:3]
    color2 = tf[..., 3:6]
    tlu, tlv = tf[..., 6], tf[..., 7]

    # checkerboard: ((int)(u*t) % 2 == 0) ^ ((int)(v*t) % 2 == 0) -> a : b
    iu = jnp.trunc(u * tlu)
    iv = jnp.trunc(v * tlv)
    even_u = jnp.abs(iu) % 2.0 < 0.5
    even_v = jnp.abs(iv) % 2.0 < 0.5
    checker_rgb = jnp.where((even_u ^ even_v)[..., None], const_rgb, color2)

    rgb = jnp.where((kind == TEX_CHECKER)[..., None], checker_rgb, const_rgb)
    alpha = jnp.ones_like(u)

    if scene.has_image_tex:
        # image: x = |(int)(u*w*tx) % w| ; y = h - |(int)(v*h*ty) % h| - 1
        w = ti[..., 2]
        h = ti[..., 3]
        wf = w.astype(u.dtype)
        hf = h.astype(u.dtype)
        xi = jnp.abs(jnp.trunc(u * wf * tlu).astype(jnp.int32)
                     % jnp.maximum(w, 1))
        yi_raw = jnp.abs(jnp.trunc(v * hf * tlv).astype(jnp.int32)
                         % jnp.maximum(h, 1))
        yi = h - yi_raw - 1
        flat = ti[..., 1] + yi * w + xi
        flat = jnp.clip(flat, 0, scene.textures.atlas.shape[0] - 1)
        texel = scene.textures.atlas[flat]
        is_img = kind == TEX_IMAGE
        rgb = jnp.where(is_img[..., None], texel[..., :3], rgb)
        alpha = jnp.where(is_img & (ti[..., 4] > 0), texel[..., 3], alpha)
    return rgb, alpha


def sample_texture(tex: Textures, tid: jnp.ndarray, uv: jnp.ndarray):
    """(rgb (R,3), alpha (R,)) for texture ids ``tid`` at ``uv``.

    Follows material.h:39-47 (checkerboard int-cast parity) and
    material.h:63-78 (image fetch with V flip and tiling).  Image texels are
    already linear (de-gamma at load).
    """
    u, v = uv[..., 0], uv[..., 1]
    kind = tex.kind[tid]

    const_rgb = tex.color[tid]

    # checkerboard: ((int)(u*t) % 2 == 0) ^ ((int)(v*t) % 2 == 0) -> a : b
    tl = tex.tiles[tid]
    iu = jnp.trunc(u * tl[..., 0])
    iv = jnp.trunc(v * tl[..., 1])
    even_u = jnp.abs(iu) % 2.0 < 0.5
    even_v = jnp.abs(iv) % 2.0 < 0.5
    checker_rgb = jnp.where((even_u ^ even_v)[..., None],
                            tex.color[tid], tex.color2[tid])

    # image: x = |(int)(u*w*tx) % w| ; y = h - |(int)(v*h*ty) % h| - 1
    w = tex.width[tid]
    h = tex.height[tid]
    wf = w.astype(u.dtype)
    hf = h.astype(u.dtype)
    xi = jnp.abs(jnp.trunc(u * wf * tl[..., 0]).astype(jnp.int32) % jnp.maximum(w, 1))
    yi_raw = jnp.abs(jnp.trunc(v * hf * tl[..., 1]).astype(jnp.int32) % jnp.maximum(h, 1))
    yi = h - yi_raw - 1
    flat = tex.offset[tid] + yi * w + xi
    flat = jnp.clip(flat, 0, tex.atlas.shape[0] - 1)
    texel = tex.atlas[flat]

    is_img = (kind == TEX_IMAGE)[..., None]
    is_chk = (kind == TEX_CHECKER)[..., None]
    rgb = jnp.where(is_img, texel[..., :3],
                    jnp.where(is_chk, checker_rgb, const_rgb))
    alpha = jnp.where(kind == TEX_IMAGE,
                      jnp.where(tex.has_alpha[tid], texel[..., 3], 1.0),
                      1.0)
    return rgb, alpha


def material_lookup_packed(scene: Scene, pack: ShadePack, mat_id, uv):
    """Packed fast path of :func:`material_lookup`: 2 + 2*2 gathers."""
    mf = pack.mat_f[mat_id]                  # (R, 3)
    mt = pack.mat_tex[mat_id]                # (R, 2)
    rgb, ta = sample_texture_packed(scene, pack, mt[..., 0], uv)
    em, _ = sample_texture_packed(scene, pack, mt[..., 1], uv)
    alpha = mf[..., 1] * ta
    return rgb, em, alpha, mf[..., 0], mf[..., 2]


def material_lookup(scene: Scene, mat_id: jnp.ndarray, uv: jnp.ndarray):
    """Gather (diffuse rgb, emissive rgb, alpha=opacity*tex_alpha, roughness,
    ior) for hit materials (material.h:84-100)."""
    m = scene.materials
    rgb, ta = sample_texture(scene.textures, m.diffuse_tex[mat_id], uv)
    em, _ = sample_texture(scene.textures, m.emissive_tex[mat_id], uv)
    alpha = m.opacity[mat_id] * ta
    return rgb, em, alpha, m.roughness[mat_id], m.ior[mat_id]


# --------------------------------------------------------------------------
# hit attribute interpolation
# --------------------------------------------------------------------------

class HitAttrs(NamedTuple):
    point: jnp.ndarray     # (R, 3)
    normal: jnp.ndarray    # (R, 3) un-flipped shading normal
    uv: jnp.ndarray        # (R, 2)
    mat_id: jnp.ndarray    # (R,)
    valid: jnp.ndarray     # (R,)


def hit_attributes_packed(scene: Scene, pack: ShadePack, ro, rd, t, prim,
                          bu, bv) -> HitAttrs:
    """Packed fast path of :func:`hit_attributes_uv`: one wide (R, 19)
    gather for all triangle attributes instead of ~8 narrow ones.
    Semantics identical (entities.h:480-487 interpolation gate)."""
    valid = prim >= 0
    total = max(scene.n_tris + scene.n_spheres + scene.n_cones - 1, 0)
    p = jnp.clip(prim, 0, total)
    is_tri = p < scene.n_tris if scene.n_tris else jnp.zeros_like(valid)
    t_safe = jnp.where(valid, t, 0.0)
    point = ro + t_safe[:, None] * rd

    if scene.n_tris:
        tp = jnp.clip(p, 0, scene.n_tris - 1)
        a = pack.tri_attr[tp]                      # (R, 19)
        n0, n1, n2 = a[:, 0:3], a[:, 3:6], a[:, 6:9]
        uv0, uv1, uv2 = a[:, 9:11], a[:, 11:13], a[:, 13:15]
        face_n = a[:, 15:18]
        has_vn = a[:, 18] > 0.5
        w0 = (1.0 - bu - bv)[:, None]
        n_interp = w0 * n0 + bu[:, None] * n1 + bv[:, None] * n2
        tri_n = jnp.where(has_vn[:, None], n_interp, face_n)
        tri_uv = w0 * uv0 + bu[:, None] * uv1 + bv[:, None] * uv2
        tri_uv = jnp.where(has_vn[:, None], tri_uv, jnp.zeros_like(tri_uv))
        tri_mat = pack.tri_mat[tp]
    else:
        tri_n = jnp.zeros_like(point)
        tri_uv = jnp.zeros_like(point[:, :2])
        tri_mat = jnp.zeros(point.shape[0], jnp.int32)

    normal, uv, mat_id = _layer_sphere_cone_attrs(
        scene, p, point, valid, is_tri, tri_n, tri_uv, tri_mat)
    return HitAttrs(point, normal, uv, mat_id, valid)


def _layer_sphere_cone_attrs(scene, p, point, valid, is_tri,
                             tri_n, tri_uv, tri_mat):
    """Sphere (entities.h:85-97) and cone attrs layered over triangle ones."""
    if scene.n_spheres:
        sp = jnp.clip(p - scene.n_tris, 0, scene.n_spheres - 1)
        c = scene.spheres.pos[sp]
        rad = scene.spheres.rad[sp]
        sph_n = (point - c) / rad[:, None]
        d = (c - point) / rad[:, None]
        sv = 0.5 + jnp.arcsin(jnp.clip(d[:, 1], -1, 1)) / jnp.pi
        su = 0.5 + jnp.arctan2(d[:, 2], d[:, 0]) / (2 * jnp.pi)
        sph_uv = jnp.stack([su, sv], -1)
        sph_mat = scene.spheres.mat_id[sp]
        normal = jnp.where(is_tri[:, None], tri_n, sph_n)
        uv = jnp.where(is_tri[:, None], tri_uv, sph_uv)
        mat_id = jnp.where(is_tri, tri_mat, sph_mat)
    else:
        normal, uv, mat_id = tri_n, tri_uv, tri_mat

    if scene.n_cones:
        from ..ops.intersect import cone_attrs
        base = scene.n_tris + scene.n_spheres
        cp = jnp.clip(p - base, 0, scene.n_cones - 1)
        cone_n, cone_uv = cone_attrs(scene.cones, point, cp)
        is_cone = p >= base
        normal = jnp.where(is_cone[:, None], cone_n, normal)
        uv = jnp.where(is_cone[:, None], cone_uv, uv)
        mat_id = jnp.where(is_cone, scene.cones.mat_id[cp], mat_id)
    return normal, uv, mat_id


def hit_attributes_uv(scene: Scene, ro, rd, t, prim, bu, bv) -> HitAttrs:
    """Interpolated position/normal/uv/material for hits, given barycentrics
    from the traversal.

    Triangles use barycentric vertex normals & uvs when present, face normal
    otherwise (entities.h:480-487); interpolated normals are deliberately NOT
    re-normalized (parity with the reference).  Spheres per entities.h:85-97.
    """
    valid = prim >= 0
    total = max(scene.n_tris + scene.n_spheres + scene.n_cones - 1, 0)
    p = jnp.clip(prim, 0, total)
    is_tri = p < scene.n_tris if scene.n_tris else jnp.zeros_like(valid)
    # miss lanes carry t=inf; sanitize so masked-out lanes never produce
    # inf/nan primals (those poison reverse-mode cotangent sums)
    t_safe = jnp.where(valid, t, 0.0)
    point = ro + t_safe[:, None] * rd

    if scene.n_tris:
        tp = jnp.clip(p, 0, scene.n_tris - 1)
        tr = scene.tris
        n0 = tr.n0[tp]; n1 = tr.n1[tp]; n2 = tr.n2[tp]
        has_vn = ((jnp.sum(n0 * n0, -1) > 0) & (jnp.sum(n1 * n1, -1) > 0)
                  & (jnp.sum(n2 * n2, -1) > 0))
        w0 = (1.0 - bu - bv)[:, None]
        n_interp = w0 * n0 + bu[:, None] * n1 + bv[:, None] * n2
        tri_n = jnp.where(has_vn[:, None], n_interp, tr.face_n[tp])
        tri_uv = (w0 * tr.uv0[tp] + bu[:, None] * tr.uv1[tp]
                  + bv[:, None] * tr.uv2[tp])
        tri_uv = jnp.where(has_vn[:, None], tri_uv, jnp.zeros_like(tri_uv))
        tri_mat = tr.mat_id[tp]
    else:
        tri_n = jnp.zeros_like(point)
        tri_uv = jnp.zeros_like(point[:, :2])
        tri_mat = jnp.zeros(point.shape[0], jnp.int32)

    normal, uv, mat_id = _layer_sphere_cone_attrs(
        scene, p, point, valid, is_tri, tri_n, tri_uv, tri_mat)
    return HitAttrs(point, normal, uv, mat_id, valid)


# --------------------------------------------------------------------------
# secondary-ray generation (BSDF select)
# --------------------------------------------------------------------------

class Secondary(NamedTuple):
    dir: jnp.ndarray        # (R,3) continuation direction
    f: jnp.ndarray          # (R,3) path weight for this bounce
    contrib: jnp.ndarray    # (R,3) RR driver (raytracer.h:376-377)
    normal: jnp.ndarray     # (R,3) flipped shading normal
    offset_sign: jnp.ndarray  # (R,) +1 reflect/diffuse, -1 refract


def secondary_ray(rd, normal, color, alpha, roughness, ior,
                  sx, sy, u_opacity, u_fresnel, contrib) -> Secondary:
    """BSDF branch select + direction sampling (raytracer.h:321-379,481-506).

    rayType: default glossy/diffuse; mirror when roughness < .001; stochastic
    refract-vs-reflect via Schlick when the opacity lottery fails.
    """
    backface = dot(normal, rd)[..., 0] > 0
    n = jnp.where(backface[:, None], -normal, normal)

    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    refl = reflect(rd, n)
    fs = r0 + (1.0 - r0) * (1.0 - dot(refl, n)[..., 0]) ** 5

    # type: 2 = diffuse/glossy, 0 = mirror, 1 = refract (raytracer.h:481-506)
    typ = jnp.full(rd.shape[0], 2, jnp.int32)
    typ = jnp.where(roughness < 0.001, 0, typ)
    lottery = u_opacity > alpha
    typ = jnp.where(lottery, jnp.where(u_fresnel < fs, 0, 1), typ)

    # refraction (eta flips on backface; raytracer.h:336-351)
    eta = jnp.where(backface, ior, 1.0 / ior)[:, None]
    d_refr = refract_tir(rd, n, eta)

    # glossy / diffuse (raytracer.h:360-378)
    d_diff = hemisphere_cos(n, sx, sy, 2.0)
    phong_pow = 1.0 / jnp.maximum(roughness, 1e-6) + 1.0
    d_phong = sample_phong(refl, phong_pow, sx, sy)
    d_phong = jnp.where(dot(d_phong, n)[..., 0:1] < 0,
                        reflect(d_phong, n), d_phong)
    d_gloss = jnp.where((roughness < 0.9)[:, None], d_phong, d_diff)

    out = jnp.where((typ == 1)[:, None], d_refr,
                    jnp.where((typ == 0)[:, None], refl, d_gloss))

    f = color  # all three branches use f = color (raytracer.h:350,357,372)
    ones = jnp.ones_like(color)
    contrib_gloss = 0.5 * (contrib * color + color)  # mix(contrib*c, c, .5)
    new_contrib = jnp.where((typ == 2)[:, None], contrib_gloss, ones)

    offset_sign = jnp.where(typ == 1, -1.0, 1.0)
    return Secondary(out, f, new_contrib, n, offset_sign)
