"""BVH traversal (the renderer's jnp walk) against the float64 brute-force
reference, over two scenes: an unstructured triangle soup and the in-repo
cornell walls (a closed box of grid triangles with shared edges)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from gi_raytracer_tpu.ops.intersect import (closest_hit, closest_hit_brute,
                                            trace_any)
from gi_raytracer_tpu.scene import SceneBuilder, load_obj

WALL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scenes", "cornell", "wall.obj")


def _soup(b, m):
    rng = np.random.default_rng(7)
    centers = rng.uniform(-5, 5, (300, 3))
    b.add_triangles(centers[:, None, :] + rng.uniform(-0.9, 0.9, (300, 3, 3)),
                    None, None, m)


def _walls(b, m):
    q = np.pi / 2
    for pos, rot in (((0, 0, 5), (0, 0, 0)), ((0, -5, 0), (q, 0, 0)),
                     ((0, 5, 0), (q, 0, 0)), ((5, 0, 0), (0, q, 0)),
                     ((-5, 0, 0), (0, q, 0))):
        tv, tn, tuv = load_obj(WALL, pos, rot)
        b.add_triangles(tv, tn, tuv, m)


@pytest.fixture(scope="module", params=["soup", "walls"])
def scene_and_rays(request):
    """(scene, alpha scene, rays): the alpha scene adds half-transparent
    and fully transparent-but-refractive triangles in front of the rest."""
    scenes = []
    for with_alpha in (False, True):
        b = SceneBuilder()
        t0 = b.add_texture_const((1, 1, 1))
        m = b.add_material(t0, t0, 1.0, 1.0, 1.0)
        (_soup if request.param == "soup" else _walls)(b, m)
        if with_alpha:
            half = b.add_material(t0, t0, 1.0, 0.5, 1.0)   # 50% accepted
            glass = b.add_material(t0, t0, 0.0, 0.0, 1.5)  # always accepted
            rng = np.random.default_rng(3)
            for k in range(40):
                c = rng.uniform(-3, 3, 3)
                b.add_triangle(c + rng.uniform(-1.5, 1.5, (3, 3)),
                               mat_id=half if k % 2 else glass)
        scenes.append(b.build(dtype=np.float64))
    rng = np.random.default_rng(11)
    R = 700
    ro = rng.uniform(-4, 4, (R, 3))
    rd = rng.normal(size=(R, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return scenes[0], scenes[1], jnp.asarray(ro), jnp.asarray(rd)


def _assert_same(got, ref):
    gp, rp = np.asarray(got.prim), np.asarray(ref.prim)
    np.testing.assert_array_equal(gp >= 0, rp >= 0)
    both = (gp >= 0) & (rp >= 0)
    # a ray through a shared edge may be claimed by either neighbour
    assert (gp == rp).mean() > 0.99
    np.testing.assert_allclose(np.asarray(got.t)[both],
                               np.asarray(ref.t)[both], rtol=1e-9)


def test_closest_matches_brute_with_tmax_and_active(scene_and_rays):
    scene, _, ro, rd = scene_and_rays
    full = closest_hit_brute(scene, ro, rd)
    hits = np.isfinite(np.asarray(full.t))
    assert hits.mean() > 0.3
    # t_max halfway to the first hit turns those hits into misses, while
    # lanes with active=False never hit
    lim = jnp.asarray(np.where(hits, np.asarray(full.t) * 0.5, 100.0))
    act = jnp.asarray(np.arange(ro.shape[0]) % 3 != 0)
    got = closest_hit(scene, ro, rd, t_max=lim, active=act)
    ref = closest_hit_brute(scene, ro, rd, t_max=lim, active=act)
    _assert_same(got, ref)
    assert (np.asarray(got.prim)[hits] == -1).all()
    _assert_same(closest_hit(scene, ro, rd, active=act),
                 closest_hit_brute(scene, ro, rd, active=act))
    assert (np.asarray(closest_hit(scene, ro, rd, active=act).prim)
            [~np.asarray(act)] == -1).all()


def test_any_hit_matches_brute(scene_and_rays):
    scene, _, ro, rd = scene_and_rays
    for limit in (1.5, 4.0, 1e9):
        occ = np.asarray(trace_any(scene, ro, rd, jnp.full(ro.shape[0],
                                                           limit)))
        ref = np.asarray(closest_hit_brute(scene, ro, rd,
                                           t_max=limit).prim) >= 0
        np.testing.assert_array_equal(occ, ref, err_msg=f"limit {limit}")


def test_stochastic_alpha_matches_brute(scene_and_rays):
    _, scene, ro, rd = scene_and_rays
    rid = jnp.arange(ro.shape[0], dtype=jnp.uint32) * 7 + 3
    for salt in (0, 12345):
        got = closest_hit(scene, ro, rd, salt=salt, ray_id=rid)
        ref = closest_hit_brute(scene, ro, rd, salt=salt, ray_id=rid)
        _assert_same(got, ref)
    # the half-opacity triangles pass some rays and stop others
    a = np.asarray(closest_hit(scene, ro, rd, salt=0, ray_id=rid).prim)
    b = np.asarray(closest_hit(scene, ro, rd, salt=12345, ray_id=rid).prim)
    assert (a != b).any()


def test_backend_choice():
    """"auto" takes the BVH walk off the GPU (the kernel compiles only
    there); an explicit choice is honoured; anything else is refused."""
    from gi_raytracer_tpu.config import RenderConfig
    from gi_raytracer_tpu.ops.intersect import intersect_backend

    assert intersect_backend(RenderConfig()) == "jnp"
    for b in ("jnp", "triton"):
        assert intersect_backend(RenderConfig(intersect_backend=b)) == b
    with pytest.raises(ValueError):
        intersect_backend(RenderConfig(intersect_backend="pallas"))
