"""BVH traversal + primitive tests vs a NumPy brute-force oracle."""

import numpy as np
import jax.numpy as jnp

from gi_raytracer_tpu.scene import SceneBuilder
from gi_raytracer_tpu.ops import closest_hit, any_hit, ray_triangle


def _random_scene(n_tris=200, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    t0 = b.add_texture_const((1, 1, 1))
    m = b.add_material(t0, t0, 1.0, 1.0, 1.0)
    centers = rng.uniform(-5, 5, (n_tris, 3))
    tris = centers[:, None, :] + rng.uniform(-0.8, 0.8, (n_tris, 3, 3))
    b.add_triangles(tris, None, None, m)
    return b.build(dtype=dtype), tris


def _brute_force(ro, rd, tris, eps=1e-5):
    """Oracle: closest-hit over all triangles in float64."""
    v0 = tris[:, 0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    t, u, v, ok = ray_triangle(jnp.asarray(ro)[:, None, :],
                               jnp.asarray(rd)[:, None, :],
                               jnp.asarray(v0), jnp.asarray(e1),
                               jnp.asarray(e2), eps)
    t = np.where(np.asarray(ok), np.asarray(t), np.inf)
    j = t.argmin(1)
    rows = np.arange(len(ro))
    best = t[rows, j]
    return np.where(np.isfinite(best), j, -1), best


def test_closest_hit_matches_brute_force():
    scene, tris = _random_scene()
    rng = np.random.default_rng(1)
    R = 500
    ro = rng.uniform(-8, 8, (R, 3))
    rd = rng.normal(size=(R, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)

    hit = closest_hit(scene, jnp.asarray(ro), jnp.asarray(rd))
    ref_prim, ref_t = _brute_force(ro, rd, tris)

    got_t = np.asarray(hit.t)
    hits = ref_prim >= 0
    assert hits.sum() > 20, "test scene degenerate"
    # distances must match (primitive ids can differ on exact ties)
    np.testing.assert_allclose(got_t[hits], ref_t[hits], rtol=1e-9)
    assert np.array_equal(np.asarray(hit.prim)[~hits],
                          np.full((~hits).sum(), -1))
    # where both hit, the primitive must agree unless distances tie
    both = hits & (np.asarray(hit.prim) >= 0)
    diff = both & (np.asarray(hit.prim) != ref_prim)
    assert np.allclose(got_t[diff], ref_t[diff])


def test_sphere_hits():
    b = SceneBuilder()
    t0 = b.add_texture_const((1, 1, 1))
    m = b.add_material(t0, t0, 1.0, 1.0)
    b.add_sphere((0, 0, 0), 1.0, m)
    # one triangle far away so the BVH isn't empty
    b.add_triangle([(50, 0, 0), (51, 0, 0), (50, 1, 0)], mat_id=m)
    scene = b.build(dtype=np.float64)

    ro = np.array([[0, 0, -5], [0, 3, -5], [0, 0, 5]], np.float64)
    rd = np.array([[0, 0, 1], [0, 0, 1], [0, 0, -1]], np.float64)
    hit = closest_hit(scene, jnp.asarray(ro), jnp.asarray(rd))
    t = np.asarray(hit.t)
    assert np.isclose(t[0], 4.0)
    assert not np.isfinite(t[1])
    assert np.isclose(t[2], 4.0)
    assert np.asarray(hit.prim)[0] == scene.n_tris  # sphere id offset


def test_any_hit_window():
    scene, tris = _random_scene(50, seed=3)
    rng = np.random.default_rng(4)
    ro = rng.uniform(-8, 8, (64, 3))
    rd = rng.normal(size=(64, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    _, ref_t = _brute_force(ro, rd, tris)
    occluded_far = np.asarray(any_hit(scene, jnp.asarray(ro), jnp.asarray(rd),
                                      jnp.full(64, 1e9)))
    assert np.array_equal(occluded_far, np.isfinite(ref_t))
    # shrinking the window below the first hit un-occludes
    lim = np.where(np.isfinite(ref_t), ref_t * 0.5, 1.0)
    occluded_near = np.asarray(any_hit(scene, jnp.asarray(ro),
                                       jnp.asarray(rd), jnp.asarray(lim)))
    assert not occluded_near[np.isfinite(ref_t)].any()


def test_stochastic_alpha_zero_opacity_never_hits():
    b = SceneBuilder()
    t0 = b.add_texture_const((1, 1, 1))
    m = b.add_material(t0, t0, 1.0, 0.0, 1.0)  # opacity 0, IOR 1
    b.add_triangle([(-5, -5, 2), (5, -5, 2), (0, 5, 2)], mat_id=m)
    scene = b.build(dtype=np.float64)
    ro = np.zeros((8, 3)); rd = np.tile([0, 0, 1.0], (8, 1))
    hit = closest_hit(scene, jnp.asarray(ro), jnp.asarray(rd))
    assert (np.asarray(hit.prim) == -1).all()


def test_stochastic_alpha_refractive_always_hits():
    b = SceneBuilder()
    t0 = b.add_texture_const((1, 1, 1))
    m = b.add_material(t0, t0, 0.0, 0.0, 1.5)  # opacity 0 but IOR != 1
    b.add_triangle([(-5, -5, 2), (5, -5, 2), (0, 5, 2)], mat_id=m)
    scene = b.build(dtype=np.float64)
    ro = np.zeros((8, 3)); rd = np.tile([0, 0, 1.0], (8, 1))
    hit = closest_hit(scene, jnp.asarray(ro), jnp.asarray(rd))
    assert (np.asarray(hit.prim) == 0).all()
