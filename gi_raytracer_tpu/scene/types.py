"""Flat SoA scene representation — the device-side scene model.

The reference stores the scene as an octree of heap-allocated polymorphic
``Entity*`` (reference include/octree.h:17-65, include/entities.h:17-49);
none of that maps to an accelerator.  Here the whole scene is a PyTree of flat arrays:
triangles and spheres as SoA buffers, materials/textures as tables indexed by
id, a threaded BVH as int32 link arrays, and the photon map as a sorted array
plus hash-grid offsets.  Every float leaf is differentiable — `jax.grad`
through the renderer yields gradients for material colors, texels, light
parameters, vertex positions and camera.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from .. import struct

# Texture kinds (textures are tables, sampled by id at shade time)
TEX_CONST = 0      # constant color (material.h:11-29)
TEX_CHECKER = 1    # procedural checkerboard (material.h:32-48)
TEX_IMAGE = 2      # image texture in the flat atlas (material.h:51-81)


@struct.dataclass
class Triangles:
    """Triangle soup with precomputed MT edges.

    Vertex normals of zero length mean "use the face normal", matching the
    reference's interpolation gate (entities.h:480-487).
    """
    v0: jnp.ndarray       # (T, 3) first vertex
    e1: jnp.ndarray       # (T, 3) v1 - v0
    e2: jnp.ndarray       # (T, 3) v2 - v0
    n0: jnp.ndarray       # (T, 3) vertex normals (may be zero)
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray      # (T, 2)
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    face_n: jnp.ndarray   # (T, 3) unit geometric normal (entities.h:339)
    mat_id: jnp.ndarray   # (T,) int32

    @property
    def count(self) -> int:
        return self.v0.shape[0]


@struct.dataclass
class Spheres:
    """Analytic spheres (entities.h:51-142)."""
    pos: jnp.ndarray      # (S, 3)
    rad: jnp.ndarray      # (S,)
    mat_id: jnp.ndarray   # (S,) int32

    @property
    def count(self) -> int:
        return self.pos.shape[0]


@struct.dataclass
class Cones:
    """Analytic finite cones (entities.h:144-299): apex on the +z axis at
    ``height`` in object space, base disk of radius ``rad`` at z=0.

    ``w2l`` is the world->object rotation (the reference's row-vector
    ``v * inverse(eulerAngleXYZ(...))``, entities.h:155-165); rays are
    transformed into object space instead of transforming the cone.
    """
    pos: jnp.ndarray      # (C, 3) base center (world)
    rad: jnp.ndarray      # (C,)
    height: jnp.ndarray   # (C,)
    w2l: jnp.ndarray      # (C, 3, 3) world->local rotation
    mat_id: jnp.ndarray   # (C,) int32

    @property
    def count(self) -> int:
        return self.pos.shape[0]


@struct.dataclass
class Lights:
    """Spherical area lights (light.h:10-58).

    ``dir``/``angle`` are the photon-emission cone precomputed from the
    specular geometry (octree.cpp:79-102).
    """
    pos: jnp.ndarray      # (L, 3)
    col: jnp.ndarray      # (L, 3)
    rad: jnp.ndarray      # (L,)
    dir: jnp.ndarray      # (L, 3) toward specular cluster
    angle: jnp.ndarray    # (L,) caustic cone fraction in [0, 1]

    @property
    def count(self) -> int:
        return self.pos.shape[0]


@struct.dataclass
class Materials:
    """Material table (material.h:84-100); textures referenced by id."""
    diffuse_tex: jnp.ndarray   # (M,) int32 texture id
    emissive_tex: jnp.ndarray  # (M,) int32 texture id
    roughness: jnp.ndarray     # (M,)
    opacity: jnp.ndarray       # (M,)
    ior: jnp.ndarray           # (M,)


@struct.dataclass
class Textures:
    """Texture table + flat texel atlas.

    Image texels live in one flat (N, 4) RGBA buffer; texture k owns rows
    [offset[k], offset[k] + width[k]*height[k]).  Texels are stored linear
    (de-gamma applied once at load, instead of per-fetch as in the reference,
    material.h:67).
    """
    kind: jnp.ndarray     # (K,) int32 in {TEX_CONST, TEX_CHECKER, TEX_IMAGE}
    color: jnp.ndarray    # (K, 3) const color / checker color a
    color2: jnp.ndarray   # (K, 3) checker color b
    tiles: jnp.ndarray    # (K, 2) tiling factors (checker: (tiles, tiles))
    offset: jnp.ndarray   # (K,) int32 into atlas
    width: jnp.ndarray    # (K,) int32
    height: jnp.ndarray   # (K,) int32
    has_alpha: jnp.ndarray  # (K,) bool
    atlas: jnp.ndarray    # (N, 4) float RGBA, linear space


@struct.dataclass
class Fog:
    """Height fog with random-noise density grid (atmosphere.h:30-83).

    The density at p is  d * noise(p)^7 * ((ymax - p.y)/size_y)^2  with noise
    trilinearly interpolated from a uniform random grid.  The reference's
    grid indexing is stride-buggy (atmosphere.h:61-71); we keep a clean
    (nx, ny, nz) grid — the grid is i.i.d. noise, so only statistics match.
    """
    bbox_min: jnp.ndarray   # (3,)
    bbox_max: jnp.ndarray   # (3,)
    color: jnp.ndarray      # (3,)
    density: jnp.ndarray    # () scalar
    scatter: jnp.ndarray    # () scalar
    grid: jnp.ndarray       # (nx, ny, nz) noise values in [0, 1)


@struct.dataclass
class BVH:
    """Flat threaded BVH in DFS preorder for stackless traversal.

    A ray at node i goes to i+1 on AABB hit (descend / enter leaf) and to
    ``skip[i]`` on miss or after processing a leaf; skip[last] == node_count
    terminates.  Replaces the reference's pointer octree (octree.cpp:316-384)
    with three int32 arrays + reordered primitive indices, gather-friendly
    for lockstep SIMD traversal.
    """
    node_min: jnp.ndarray    # (N, 3)
    node_max: jnp.ndarray    # (N, 3)
    skip: jnp.ndarray        # (N,) int32 preorder escape link
    first: jnp.ndarray       # (N,) int32 first prim slot (leaves)
    count: jnp.ndarray       # (N,) int32 prim count (0 for inner nodes)
    prim_idx: jnp.ndarray    # (P,) int32 triangle ids (spheres are few and
                             #   tested densely outside the BVH)
    leaf_size: int = struct.static_field(default=4)

    @property
    def n_nodes(self) -> int:
        return self.skip.shape[0]


@struct.dataclass
class Scene:
    """The complete device-side scene."""
    tris: Triangles
    spheres: Spheres
    cones: Cones | None
    lights: Lights
    materials: Materials
    textures: Textures
    bvh: BVH
    fog: Fog | None = None
    world_min: jnp.ndarray = None   # (3,) root bounds
    world_max: jnp.ndarray = None
    # static: no material needs the stochastic-alpha lottery (opacity < 1
    # only matters when ior == 1, raytracer.h:455,297)
    all_opaque: bool = struct.static_field(default=False)
    # static: any TEX_IMAGE textures present — lets shading skip the texel
    # atlas gather entirely on const/checker-only scenes
    has_image_tex: bool = struct.static_field(default=True)

    # camera & per-scene render settings are carried by the loader, not here

    @property
    def n_tris(self) -> int:
        return self.tris.count

    @property
    def n_spheres(self) -> int:
        return self.spheres.count

    @property
    def n_cones(self) -> int:
        return 0 if self.cones is None else self.cones.count

    @property
    def has_fog(self) -> bool:
        return self.fog is not None


def astype_tree(tree: Any, dtype) -> Any:
    """Cast every float leaf of a pytree to ``dtype`` (int leaves untouched)."""
    import jax

    def cast(x):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x

    return jax.tree_util.tree_map(cast, tree)
