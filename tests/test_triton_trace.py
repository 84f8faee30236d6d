"""The Triton-route traversal kernel (Pallas interpreter on the CPU) against
the BVH walk: closest hit, t limits and inactive lanes, any-hit, stochastic
alpha, and grouped chunk walks."""

import numpy as np
import jax.numpy as jnp
import pytest

from gi_raytracer_tpu.ops import triton_trace as tt
from gi_raytracer_tpu.ops.intersect import _bvh_walk, ray_triangle
from gi_raytracer_tpu.scene import SceneBuilder


@pytest.fixture(scope="module")
def scene_and_rays():
    rng = np.random.default_rng(7)
    b = SceneBuilder()
    t0 = b.add_texture_const((1, 1, 1))
    m = b.add_material(t0, t0, 1.0, 1.0, 1.0)
    centers = rng.uniform(-5, 5, (300, 3))
    tris = centers[:, None, :] + rng.uniform(-0.9, 0.9, (300, 3, 3))
    b.add_triangles(tris, None, None, m)
    scene = b.build(dtype=np.float32)
    R = 700   # not a multiple of the ray block: exercises padding
    ro = rng.uniform(-8, 8, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return scene, jnp.asarray(ro), jnp.asarray(rd)


def _query(scene, ro, rd, **kw):
    t, prim = tt.triangle_query(scene, ro, rd, interpret=True, **kw)
    return np.asarray(t), np.asarray(prim)


def test_kernel_matches_walk_closest(scene_and_rays):
    scene, ro, rd = scene_and_rays
    ref = _bvh_walk(scene, ro, rd)
    t, prim = _query(scene, ro, rd)
    hits = np.asarray(ref.prim) >= 0
    np.testing.assert_array_equal(prim >= 0, hits)
    assert (prim == np.asarray(ref.prim))[hits].mean() > 0.99
    # the kernel's t is its ordering key (separable form, float32); the
    # renderer recomputes the winner's exact t, which matches the walk's
    np.testing.assert_allclose(t[hits], np.asarray(ref.t)[hits], rtol=1e-4)
    p = jnp.asarray(np.maximum(prim, 0))
    exact, _, _, ok = ray_triangle(ro, rd, scene.tris.v0[p],
                                   scene.tris.e1[p], scene.tris.e2[p], 1e-5)
    assert np.asarray(ok)[hits].all()
    np.testing.assert_allclose(np.asarray(exact)[hits],
                               np.asarray(ref.t)[hits], rtol=1e-5)


def test_kernel_hits_from_outside_the_scene_bounds(scene_and_rays):
    """Camera rays start outside the scene and may travel further than its
    diagonal before their hit."""
    scene, _, _ = scene_and_rays
    rng = np.random.default_rng(5)
    tgt = rng.uniform(-4, 4, (300, 3))
    ro = tgt + 40.0 * np.array([0.3, 0.4, -0.866])
    rd = (tgt - ro) / np.linalg.norm(tgt - ro, axis=1, keepdims=True)
    ro, rd = jnp.asarray(ro, jnp.float32), jnp.asarray(rd, jnp.float32)
    ref = np.asarray(_bvh_walk(scene, ro, rd).prim)
    assert (ref >= 0).mean() > 0.2
    _, prim = _query(scene, ro, rd)
    assert (prim == ref).mean() > 0.99


def test_kernel_respects_tmax_and_active(scene_and_rays):
    scene, ro, rd = scene_and_rays
    rt = np.asarray(_bvh_walk(scene, ro, rd).t)
    hits = np.isfinite(rt)
    lim = jnp.asarray(np.where(hits, rt * 0.5, 1.0).astype(np.float32))
    _, prim = _query(scene, ro, rd, t_max=lim)
    assert (prim[hits] == -1).all()
    _, prim = _query(scene, ro, rd, active=jnp.zeros(ro.shape[0], bool))
    assert (prim == -1).all()


def test_kernel_any_hit(scene_and_rays):
    scene, ro, rd = scene_and_rays
    for limit in (2.0, 1e9):
        ref = np.asarray(_bvh_walk(scene, ro, rd, t_max=limit).prim) >= 0
        _, prim = _query(scene, ro, rd, t_max=jnp.full(ro.shape[0], limit),
                         any_hit=True)
        np.testing.assert_array_equal(prim >= 0, ref)


def test_kernel_stochastic_alpha_matches_walk():
    rng = np.random.default_rng(3)
    b = SceneBuilder()
    t0 = b.add_texture_const((1, 1, 1))
    clear = b.add_material(t0, t0, 1.0, 0.0, 1.0)   # opacity 0: never hit
    glass = b.add_material(t0, t0, 1.0, 0.0, 1.5)   # refractive: always hit
    half = b.add_material(t0, t0, 1.0, 0.5, 1.0)    # hit half the time
    b.add_triangle([(-9, -9, 2), (9, -9, 2), (0, 9, 2)], mat_id=clear)
    b.add_triangle([(-9, -9, 5), (9, -9, 5), (0, 9, 5)], mat_id=glass)
    for k in range(60):
        c = rng.uniform(-3, 3, 3) * np.array([1, 1, 0]) + np.array([0, 0, 3.5])
        b.add_triangle(c + rng.uniform(-1, 1, (3, 3)), mat_id=half)
    scene = b.build(dtype=np.float32)
    assert not scene.all_opaque
    R = 256
    ro = jnp.asarray(np.c_[rng.uniform(-2, 2, (R, 2)), np.zeros(R)],
                     jnp.float32)
    rd = jnp.tile(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (R, 1))
    rid = jnp.arange(R, dtype=jnp.uint32) * 5 + 1
    refs = []
    for salt in (0, 777):
        refs.append(np.asarray(_bvh_walk(scene, ro, rd, salt=salt,
                                         ray_id=rid).prim))
        _, prim = _query(scene, ro, rd, salt=salt, ray_id=rid)
        np.testing.assert_array_equal(prim, refs[-1])
    # every ray stops somewhere (the glass plane), and the half-opacity
    # lottery changes with the salt
    assert (refs[0] >= 0).all() and (refs[0] != refs[1]).any()


@pytest.mark.parametrize("any_hit", [False, True])
def test_grouped_walk_matches_single_chunks(scene_and_rays, monkeypatch,
                                            any_hit):
    """Several chunks per group (large scenes) give the same winners as one
    chunk per group."""
    scene, ro, rd = scene_and_rays
    lim = jnp.full(ro.shape[0], 6.0 if any_hit else 1e9)
    _, single = _query(scene, ro, rd, t_max=lim, any_hit=any_hit)
    assert tt.group_size(scene.n_tris) == 1
    monkeypatch.setattr(tt, "MAX_GROUPS", 2)
    assert tt.group_size(scene.n_tris) == 4
    _, grouped = _query(scene, ro, rd, t_max=lim, any_hit=any_hit)
    if any_hit:
        np.testing.assert_array_equal(single >= 0, grouped >= 0)
    else:
        np.testing.assert_array_equal(single, grouped)


@pytest.mark.gpu
def test_compiled_kernel_matches_walk_on_gpu(gpu, scene_and_rays):
    """The kernel as the GPU compiles it (no interpreter)."""
    scene, ro, rd = scene_and_rays
    ref = np.asarray(_bvh_walk(scene, ro, rd).prim)
    _, prim = tt.triangle_query(scene, ro, rd)
    assert (np.asarray(prim) == ref).mean() > 0.99
