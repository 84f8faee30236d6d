"""Host-side scene compiler: accumulates primitives/materials in NumPy and
emits the flat device `Scene` (+ BVH).  Replaces the reference's octree
insertion path (octree.cpp:25-38, sceneLoader.cpp) with array construction.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import jax.numpy as jnp

from . import types as T
from .bvh import build_bvh


def euler_xyz(rx: float, ry: float, rz: float) -> np.ndarray:
    """Rotation matrix Rx(rx) @ Ry(ry) @ Rz(rz), the glm::eulerAngleXYZ
    convention used by the loaders (meshLoader.cpp:26, entities.h:655)."""
    cx, sx = math.cos(rx), math.sin(rx)
    cy, sy = math.cos(ry), math.sin(ry)
    cz, sz = math.cos(rz), math.sin(rz)
    rxm = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    rym = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rzm = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rxm @ rym @ rzm


@dataclasses.dataclass
class _TexDef:
    kind: int
    color: tuple = (0.0, 0.0, 0.0)
    color2: tuple = (0.0, 0.0, 0.0)
    tiles: tuple = (1.0, 1.0)
    image: np.ndarray | None = None   # (H, W, 4) float RGBA, linear
    has_alpha: bool = False


class SceneBuilder:
    """Accumulates scene content, then compiles to a device `Scene`."""

    def __init__(self):
        self._tri_v = []       # (3,3) vertex positions
        self._tri_n = []       # (3,3) vertex normals (zeros => face normal)
        self._tri_uv = []      # (3,2)
        self._tri_mat = []
        self._sph_pos, self._sph_rad, self._sph_mat = [], [], []
        self._cone = []        # (pos, rot, rad, height, mat_id)
        self._light_pos, self._light_col, self._light_rad = [], [], []
        self._tex: list[_TexDef] = []
        self._mat = []         # (dif, em, rough, opac, ior)
        self._fog = None
        self._fog_seed = 0

    # --- content ------------------------------------------------------------
    def add_texture_const(self, color) -> int:
        self._tex.append(_TexDef(T.TEX_CONST, tuple(color)))
        return len(self._tex) - 1

    def add_texture_checker(self, tiles: int, a, b) -> int:
        self._tex.append(_TexDef(T.TEX_CHECKER, tuple(a), tuple(b),
                                 (float(tiles), float(tiles))))
        return len(self._tex) - 1

    def add_texture_image(self, image_rgba: np.ndarray, tiles=(1.0, 1.0),
                          has_alpha: bool = False) -> int:
        """image_rgba: (H, W, 4) float32 in linear space."""
        assert image_rgba.ndim == 3 and image_rgba.shape[2] == 4
        self._tex.append(_TexDef(T.TEX_IMAGE, tiles=tuple(tiles),
                                 image=image_rgba.astype(np.float32),
                                 has_alpha=has_alpha))
        return len(self._tex) - 1

    def add_material(self, diffuse_tex: int, emissive_tex: int,
                     roughness: float, opacity: float, ior: float = 1.0) -> int:
        self._mat.append((diffuse_tex, emissive_tex, roughness, opacity, ior))
        return len(self._mat) - 1

    def add_triangle(self, verts, normals=None, uvs=None, mat_id: int = 0):
        v = np.asarray(verts, np.float64).reshape(3, 3)
        n = (np.zeros((3, 3)) if normals is None
             else np.asarray(normals, np.float64).reshape(3, 3))
        # normalize nonzero vertex normals (vertex ctor, entities.h:313)
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        n = np.where(ln > 0, n / np.maximum(ln, 1e-300), 0.0)
        uv = (np.zeros((3, 2)) if uvs is None
              else np.asarray(uvs, np.float64).reshape(3, 2))
        self._tri_v.append(v)
        self._tri_n.append(n)
        self._tri_uv.append(uv)
        self._tri_mat.append(mat_id)

    def add_triangles(self, verts, normals=None, uvs=None, mat_id: int = 0):
        """Bulk add: verts (N,3,3), normals (N,3,3) or None, uvs (N,3,2)."""
        verts = np.asarray(verts, np.float64)
        for i in range(verts.shape[0]):
            self.add_triangle(verts[i],
                              None if normals is None else normals[i],
                              None if uvs is None else uvs[i],
                              mat_id)

    def add_sphere(self, pos, rad: float, mat_id: int):
        self._sph_pos.append(tuple(pos))
        self._sph_rad.append(float(rad))
        self._sph_mat.append(mat_id)

    def add_cone(self, pos, rot, rad: float, height: float, mat_id: int):
        """Analytic finite cone: base disk radius ``rad`` at local z=0,
        apex at z=``height`` (entities.h:144-156); ``rot`` = euler XYZ."""
        self._cone.append((tuple(pos), tuple(rot), float(rad), float(height),
                           int(mat_id)))

    def add_light(self, pos, col, rad: float):
        self._light_pos.append(tuple(pos))
        self._light_col.append(tuple(col))
        self._light_rad.append(float(rad))

    def add_height_fog(self, pos, size, col, density, scatter, noise_scale,
                       seed: int = 0):
        self._fog = (np.asarray(pos, np.float64), np.asarray(size, np.float64),
                     np.asarray(col, np.float64), float(density),
                     float(scatter), int(noise_scale))
        self._fog_seed = seed

    # --- compile ------------------------------------------------------------
    def _light_cones(self, dtype):
        """Per-light photon-emission cone toward the specular geometry
        (octree.cpp:60-102): dir = avg specular bbox-center minus light;
        angle = max over specular prims of 1 - acos(dot(dir, l-ˆ-corner))/pi."""
        L = len(self._light_pos)
        dirs = np.zeros((L, 3))
        angles = np.zeros(L)
        mats = np.asarray(self._mat, np.float64) if self._mat else np.zeros((0, 5))
        rough = mats[:, 2] if len(mats) else np.zeros(0)

        spec_centers, spec_mins = [], []
        for v, m in zip(self._tri_v, self._tri_mat):
            if rough[m] < 0.1:
                # triangle bbox max gets +EPSILON per axis (entities.h:547-549)
                bmin, bmax = v.min(0), v.max(0) + 1e-5
                spec_centers.append((bmin + bmax) / 2)
                spec_mins.append(bmin)
        for p, r, m in zip(self._sph_pos, self._sph_rad, self._sph_mat):
            if rough[m] < 0.1:
                p = np.asarray(p)
                spec_centers.append(p)
                spec_mins.append(p - r)
        if spec_centers:
            avg = np.mean(spec_centers, 0)
            for i, lp in enumerate(self._light_pos):
                lp = np.asarray(lp)
                d = avg - lp
                d /= np.linalg.norm(d)
                dirs[i] = d
                best = 0.0
                for bmin in spec_mins:
                    w = lp - bmin
                    w = w / np.linalg.norm(w)
                    a = 1.0 - math.acos(np.clip(np.dot(d, w), -1, 1)) / math.pi
                    best = max(best, a)
                angles[i] = best
        return dirs.astype(dtype), angles.astype(dtype)

    def build(self, dtype=np.float32, leaf_size: int = 4) -> T.Scene:
        f = dtype
        Tn = len(self._tri_v)
        if Tn:
            v = np.stack(self._tri_v)             # (T,3,3)
            n = np.stack(self._tri_n)
            uv = np.stack(self._tri_uv)
        else:
            v = np.zeros((0, 3, 3)); n = np.zeros((0, 3, 3)); uv = np.zeros((0, 3, 2))
        # --- BVH over triangles, built FIRST so the triangle arrays can be
        # permuted into BVH leaf order: consecutive triangles are then
        # spatially coherent, which the chunked traversal kernel
        # (ops.triton_trace) culls by (insertion order is mesh-file order —
        # scattered AABBs defeat every chunk cull)
        tri_min = v.min(1) if Tn else np.zeros((0, 3))
        tri_max = (v.max(1) + 1e-5) if Tn else np.zeros((0, 3))  # entities.h:547
        bvh_np = build_bvh(tri_min, tri_max, leaf_size=leaf_size)
        perm = (np.asarray(bvh_np.prim_idx, np.int64) if Tn
                else np.zeros(0, np.int64))
        v, n, uv = v[perm], n[perm], uv[perm]
        tri_min, tri_max = tri_min[perm], tri_max[perm]
        tri_mat_arr = np.asarray(self._tri_mat, np.int32).reshape(Tn)[perm]

        e1 = v[:, 1] - v[:, 0]
        e2 = v[:, 2] - v[:, 0]
        fn = np.cross(e1, e2)
        ln = np.linalg.norm(fn, axis=1, keepdims=True)
        fn = fn / np.maximum(ln, 1e-300)

        tris = T.Triangles(
            v0=jnp.asarray(v[:, 0], f), e1=jnp.asarray(e1, f),
            e2=jnp.asarray(e2, f),
            n0=jnp.asarray(n[:, 0], f), n1=jnp.asarray(n[:, 1], f),
            n2=jnp.asarray(n[:, 2], f),
            uv0=jnp.asarray(uv[:, 0], f), uv1=jnp.asarray(uv[:, 1], f),
            uv2=jnp.asarray(uv[:, 2], f),
            face_n=jnp.asarray(fn, f),
            mat_id=jnp.asarray(tri_mat_arr),
        )

        sp = np.asarray(self._sph_pos, np.float64).reshape(-1, 3)
        sr = np.asarray(self._sph_rad, np.float64)
        spheres = T.Spheres(pos=jnp.asarray(sp, f), rad=jnp.asarray(sr, f),
                            mat_id=jnp.asarray(self._sph_mat, np.int32))

        # analytic cones: world->local rotation is glm's row-vector
        # ``v * inverse(eulerAngleXYZ(r))`` (entities.h:155-165), which for an
        # orthonormal euler matrix M reduces to  local = M @ (world - pos).
        nC = len(self._cone)
        if nC:
            cpos = np.asarray([c[0] for c in self._cone], np.float64)
            crad = np.asarray([c[2] for c in self._cone], np.float64)
            chei = np.asarray([c[3] for c in self._cone], np.float64)
            cw2l = np.stack([euler_xyz(*c[1]) for c in self._cone])
            cmat = np.asarray([c[4] for c in self._cone], np.int32)
            cones = T.Cones(pos=jnp.asarray(cpos, f), rad=jnp.asarray(crad, f),
                            height=jnp.asarray(chei, f),
                            w2l=jnp.asarray(cw2l, f),
                            mat_id=jnp.asarray(cmat))
            # bbox from the 5 transformed pyramid verts (entities.h:260-299)
            base = np.array([[-1, -1, 0], [-1, 1, 0], [1, -1, 0], [1, 1, 0],
                             [0, 0, 0]], np.float64)
            verts = base[None] * crad[:, None, None]
            verts[:, 4, 2] = chei
            world = np.einsum("cji,cvj->cvi", cw2l, verts) + cpos[:, None]
            cone_min = world.min(1)
            cone_max = world.max(1)
        else:
            cones = None
            cone_min = np.zeros((0, 3)); cone_max = np.zeros((0, 3))

        ldir, langle = self._light_cones(np.float64)
        lights = T.Lights(
            pos=jnp.asarray(np.asarray(self._light_pos, np.float64).reshape(-1, 3), f),
            col=jnp.asarray(np.asarray(self._light_col, np.float64).reshape(-1, 3), f),
            rad=jnp.asarray(self._light_rad, f),
            dir=jnp.asarray(ldir, f), angle=jnp.asarray(langle, f))

        mats = (np.asarray(self._mat, np.float64) if self._mat
                else np.zeros((1, 5)) + [[0, 0, 0.75, 1, 1]])  # default mat, entities.h:19
        materials = T.Materials(
            diffuse_tex=jnp.asarray(mats[:, 0], np.int32),
            emissive_tex=jnp.asarray(mats[:, 1], np.int32),
            roughness=jnp.asarray(mats[:, 2], f),
            opacity=jnp.asarray(mats[:, 3], f),
            ior=jnp.asarray(mats[:, 4], f))

        textures = self._build_textures(f)

        # triangle arrays are already in BVH leaf order -> identity prim map
        bvh = T.BVH(node_min=jnp.asarray(bvh_np.node_min, f),
                    node_max=jnp.asarray(bvh_np.node_max, f),
                    skip=jnp.asarray(bvh_np.skip),
                    first=jnp.asarray(bvh_np.first),
                    count=jnp.asarray(bvh_np.count),
                    prim_idx=jnp.asarray(np.arange(Tn, dtype=np.int32)),
                    leaf_size=leaf_size)

        sph_min = sp - sr[:, None] if len(sr) else np.zeros((0, 3))
        sph_max = sp + sr[:, None] if len(sr) else np.zeros((0, 3))
        pmin = np.concatenate([tri_min, sph_min, cone_min], 0)
        pmax = np.concatenate([tri_max, sph_max, cone_max], 0)
        wmin = pmin.min(0) if len(pmin) else np.zeros(3)
        wmax = pmax.max(0) if len(pmax) else np.ones(3)

        fog = None
        if self._fog is not None:
            pos, size, col, dens, scat, nscale = self._fog
            rng = np.random.default_rng(self._fog_seed)
            # grid resolution ~ one cell per world unit times noise scale,
            # mirroring the reference's allocation (atmosphere.h:39-47)
            res = np.maximum(2, (size * max(1, nscale)).astype(int) + 1)
            grid = rng.random(tuple(res))
            fog = T.Fog(bbox_min=jnp.asarray(pos - 0.5 * size, f),
                        bbox_max=jnp.asarray(pos + 0.5 * size, f),
                        color=jnp.asarray(col, f),
                        density=jnp.asarray(dens, f),
                        scatter=jnp.asarray(scat, f),
                        grid=jnp.asarray(grid, f))

        all_opaque = bool(np.all((mats[:, 3] >= 1.0) | (mats[:, 4] != 1.0)))
        has_img = any(t.kind == T.TEX_IMAGE for t in (self._tex or []))
        return T.Scene(all_opaque=all_opaque, has_image_tex=has_img,
                       tris=tris, spheres=spheres, cones=cones, lights=lights,
                       materials=materials, textures=textures, bvh=bvh,
                       fog=fog,
                       world_min=jnp.asarray(wmin, f),
                       world_max=jnp.asarray(wmax, f))

    def _build_textures(self, f) -> T.Textures:
        tex = self._tex or [_TexDef(T.TEX_CONST, (1.0, 0.0, 0.0))]
        K = len(tex)
        kind = np.zeros(K, np.int32)
        color = np.zeros((K, 3)); color2 = np.zeros((K, 3))
        tiles = np.ones((K, 2)); offset = np.zeros(K, np.int32)
        width = np.ones(K, np.int32); height = np.ones(K, np.int32)
        has_alpha = np.zeros(K, bool)
        atlas_parts = []
        cursor = 0
        for i, t in enumerate(tex):
            kind[i] = t.kind
            color[i] = t.color
            color2[i] = t.color2
            tiles[i] = t.tiles
            if t.kind == T.TEX_IMAGE:
                h, w = t.image.shape[:2]
                offset[i] = cursor
                width[i], height[i] = w, h
                has_alpha[i] = t.has_alpha
                atlas_parts.append(t.image.reshape(-1, 4))
                cursor += w * h
        atlas = (np.concatenate(atlas_parts, 0) if atlas_parts
                 else np.ones((1, 4), np.float32))
        return T.Textures(kind=jnp.asarray(kind),
                          color=jnp.asarray(color, f),
                          color2=jnp.asarray(color2, f),
                          tiles=jnp.asarray(tiles, f),
                          offset=jnp.asarray(offset),
                          width=jnp.asarray(width), height=jnp.asarray(height),
                          has_alpha=jnp.asarray(has_alpha),
                          atlas=jnp.asarray(atlas, f))
