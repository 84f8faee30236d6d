"""Native C++ components vs their NumPy/Python twins."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from gi_raytracer_tpu.native import get_lib, build_bvh_native, load_obj_native
from gi_raytracer_tpu.scene.bvh import _build_bvh_numpy
from gi_raytracer_tpu.scene.objio import load_obj

needs_native = pytest.mark.skipif(get_lib() is None,
                                  reason="native toolchain unavailable")


def _check_bvh_invariants(b, pmin, pmax):
    n = len(b.skip)
    P = len(pmin)
    assert sorted(b.prim_idx.tolist()) == list(range(P))
    # skip links: strictly forward, last escapes to n
    assert (b.skip > np.arange(n)).all()
    assert (b.skip <= n).all()
    # leaves cover every prim exactly once, inner nodes have count 0
    leaves = b.count > 0
    covered = np.zeros(P, bool)
    for f, c in zip(b.first[leaves], b.count[leaves]):
        assert not covered[f:f + c].any()
        covered[f:f + c] = True
    assert covered.all()
    # node boxes contain their leaf prims
    for i in np.where(leaves)[0]:
        ids = b.prim_idx[b.first[i]:b.first[i] + b.count[i]]
        assert (pmin[ids] >= b.node_min[i] - 1e-4).all()
        assert (pmax[ids] <= b.node_max[i] + 1e-4).all()


@needs_native
def test_native_bvh_invariants_and_query_equivalence():
    rng = np.random.default_rng(0)
    c = rng.uniform(-5, 5, (500, 3))
    pmin = c - rng.uniform(0.05, 0.5, (500, 3))
    pmax = c + rng.uniform(0.05, 0.5, (500, 3))
    nb = build_bvh_native(pmin, pmax, 4)
    assert nb is not None
    _check_bvh_invariants(nb, pmin, pmax)
    _check_bvh_invariants(_build_bvh_numpy(pmin, pmax, 4), pmin, pmax)


@needs_native
def test_native_bvh_closest_hit_matches_numpy_tree():
    """Same hits through either tree (trees differ, results must not)."""
    from gi_raytracer_tpu.scene import SceneBuilder
    from gi_raytracer_tpu.ops import closest_hit

    rng = np.random.default_rng(5)
    tris = (rng.uniform(-5, 5, (200, 1, 3))
            + rng.uniform(-0.8, 0.8, (200, 3, 3)))

    hits = []
    for use_native in (False, True):
        import gi_raytracer_tpu.scene.bvh as bvh_mod
        orig = bvh_mod.build_bvh
        try:
            def patched(pmin, pmax, leaf_size=4, un=use_native):
                return orig(pmin, pmax, leaf_size, use_native=un)
            bvh_mod.build_bvh = patched
            import gi_raytracer_tpu.scene.build as build_mod
            build_mod.build_bvh = patched
            b = SceneBuilder()
            t0 = b.add_texture_const((1, 1, 1))
            m = b.add_material(t0, t0, 1.0, 1.0)
            b.add_triangles(tris, None, None, m)
            scene = b.build(dtype=np.float64)
        finally:
            bvh_mod.build_bvh = orig
            import gi_raytracer_tpu.scene.build as build_mod
            build_mod.build_bvh = orig
        ro = rng.uniform(-8, 8, (200, 3))
        rd = rng.normal(size=(200, 3))
        rd /= np.linalg.norm(rd, axis=1, keepdims=True)
        rng = np.random.default_rng(5)  # reset so both variants match
        rng.uniform(-5, 5, (200, 1, 3)); rng.uniform(-0.8, 0.8, (200, 3, 3))
        h = closest_hit(scene, jnp.asarray(ro), jnp.asarray(rd))
        hits.append((np.asarray(h.t), np.asarray(h.prim)))
    (t0_, p0), (t1, p1) = hits
    both = np.isfinite(t0_) & np.isfinite(t1)
    assert (np.isfinite(t0_) == np.isfinite(t1)).all()
    np.testing.assert_allclose(t0_[both], t1[both], rtol=1e-6)


@needs_native
def test_native_obj_matches_python():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", "cornell", "wall.obj")
    tv_py, tn_py, tuv_py = load_obj(path)
    raw = load_obj_native(path)
    assert raw is not None
    v, vt, vn, fv, ft, fn = raw
    assert fv.shape[0] % 3 == 0
    n_faces = fv.shape[0] // 3
    assert n_faces == tv_py.shape[0]
    tv_nat = v[fv.reshape(-1, 3) - 1]
    np.testing.assert_allclose(tv_nat, tv_py, atol=1e-5)


def test_native_library_builds_from_sources(tmp_path):
    """The library is compiled from the committed sources into a file named
    by their hash, and an existing build is reused, not rebuilt."""
    import ctypes
    from gi_raytracer_tpu import native

    so = native._compile(str(tmp_path))
    if so is None:
        pytest.skip("no C++ compiler")
    assert so == native.library_path(str(tmp_path))
    assert os.path.basename(so).startswith("_gi_native-")
    lib = ctypes.CDLL(so)
    assert hasattr(lib, "gi_build_bvh") and hasattr(lib, "gi_obj_parse")
    mtime = os.path.getmtime(so)
    assert native._compile(str(tmp_path)) == so
    assert os.path.getmtime(so) == mtime
    assert [p.name for p in tmp_path.iterdir()] == [os.path.basename(so)]
