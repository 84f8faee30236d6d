"""Atmosphere (height fog): density/bounds/march unit tests vs float64
NumPy oracles + an end-to-end foggy render (atmosphere.h:30-83,
raytracer.h:509-529)."""

import numpy as np
import jax.numpy as jnp

from gi_raytracer_tpu.config import RenderConfig
from gi_raytracer_tpu.scene import SceneBuilder
from gi_raytracer_tpu.render import Camera
from gi_raytracer_tpu.render.integrator import render_image
from gi_raytracer_tpu.render.atmosphere import (fog_density, _fog_bounds,
                                                _march, fog_occludes)


def _foggy_scene(density=1.0, seed=0):
    b = SceneBuilder()
    white = b.add_texture_const((0.9, 0.9, 0.9))
    black = b.add_texture_const((0.0, 0.0, 0.0))
    m = b.add_material(white, black, 1.0, 1.0, 1.0)
    from gi_raytracer_tpu.scene.meshgen import quad_mesh
    b.add_triangles(quad_mesh((-20, -2, -20), (20, -2, -20), (-20, -2, 20),
                              (20, -2, 20)), mat_id=m)
    b.add_height_fog((0, 1, 0), (8, 4, 8), (0.8, 0.85, 0.9),
                     density, 1.0, 1.0, seed=seed)
    b.add_light((0.0, 8.0, 0.0), (30.0, 30.0, 30.0), 0.3)
    return b.build(dtype=np.float64)


def _oracle_density(scene, p):
    """Reference math in float64 NumPy: trilinear(noise)^7 * height falloff
    * d (atmosphere.h:50-81)."""
    fog = scene.fog
    bmin = np.asarray(fog.bbox_min)
    bmax = np.asarray(fog.bbox_max)
    g = np.asarray(fog.grid)
    nx, ny, nz = g.shape
    size = bmax - bmin
    out = np.zeros(p.shape[0])
    for i, q in enumerate(p):
        if not ((q >= bmin).all() and (q <= bmax).all()):
            continue
        rel = q - bmin
        gx = min(max(rel[0], 0.0), nx - 1.001)
        gy = min(max(rel[1], 0.0), ny - 1.001)
        gz = min(max(rel[2], 0.0), nz - 1.001)
        ix, iy, iz = int(gx), int(gy), int(gz)
        dx, dy, dz = gx - ix, gy - iy, gz - iz

        def at(ox, oy, oz):
            return g[min(ix + ox, nx - 1), min(iy + oy, ny - 1),
                     min(iz + oz, nz - 1)]

        c00 = at(0, 0, 0) * (1 - dx) + at(1, 0, 0) * dx
        c01 = at(0, 0, 1) * (1 - dx) + at(1, 0, 1) * dx
        c10 = at(0, 1, 0) * (1 - dx) + at(1, 1, 0) * dx
        c11 = at(0, 1, 1) * (1 - dx) + at(1, 1, 1) * dx
        c0 = c00 * (1 - dy) + c10 * dy
        c1 = c01 * (1 - dy) + c11 * dy
        noise = (c0 * (1 - dz) + c1 * dz) ** 7
        falloff = ((bmax[1] - q[1]) / size[1]) ** 2
        out[i] = float(fog.density) * noise * falloff
    return out


def test_fog_density_matches_oracle():
    scene = _foggy_scene(density=2.5, seed=3)
    rng = np.random.default_rng(0)
    p = rng.uniform(-5, 5, (256, 3))  # straddles the fog bbox
    got = np.asarray(fog_density(scene, jnp.asarray(p)))
    want = _oracle_density(scene, p)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    assert (want > 0).any(), "oracle all zero — test covers nothing"
    # outside the bbox the density must be exactly zero
    outside = ~((p >= np.asarray(scene.fog.bbox_min)).all(1)
                & (p <= np.asarray(scene.fog.bbox_max)).all(1))
    assert (got[outside] == 0).all()


def test_fog_bounds_overlap():
    scene = _foggy_scene()
    ro = jnp.asarray([[0.0, 1.0, -10.0],   # enters the box from -z
                      [0.0, 50.0, 0.0],    # passes above
                      [0.0, 1.0, 0.0]])    # starts inside
    rd = jnp.asarray([[0.0, 0.0, 1.0],
                      [0.0, 0.0, 1.0],
                      [0.0, 0.0, 1.0]])
    tmin, tmax, has = _fog_bounds(scene, ro, rd, jnp.full(3, 100.0))
    has = np.asarray(has)
    assert has[0] and not has[1] and has[2]
    np.testing.assert_allclose(float(tmin[0]), 6.0, atol=1e-6)   # z=-4 face
    np.testing.assert_allclose(float(tmax[0]), 14.0, atol=1e-6)  # z=+4 face
    np.testing.assert_allclose(float(tmin[2]), 0.0, atol=1e-6)


def test_march_scatter_statistics():
    """With density d constant along the segment, each 0.04-step scatters
    w.p. d => P(no scatter over L) = (1-d)^(L/step).  The march's empirical
    scatter fraction over many rays must match within ~4 sigma."""
    scene = _foggy_scene(density=1.0)
    # overwrite the noise grid with ones and kill the height falloff by
    # marching at the bbox floor... instead: set grid=1 and compute the
    # expected per-step probability from the oracle density at the ray's y
    scene = scene.replace(fog=scene.fog.replace(
        grid=jnp.ones_like(scene.fog.grid)))
    cfg = RenderConfig(dtype="float64", raymarch_max_steps=512)
    R = 4096
    y = 0.0  # fog spans y in [-1, 3]; falloff = ((3 - 0)/4)^2 = 0.5625
    d = 1.0 * 0.5625
    ro = jnp.stack([jnp.linspace(-3.9, 3.9, R), jnp.full(R, y),
                    jnp.full(R, -3.9)], axis=1)
    rd = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (R, 3))
    tmin, tmax, has = _fog_bounds(scene, ro, rd, jnp.full(R, 7.8))
    found, t_hit = _march(scene, cfg, ro, rd, tmin, tmax, has, 7)
    frac = float(np.asarray(found).mean())
    L = 7.8
    steps = int(L / cfg.raymarch_stepsize)
    p_scatter = 1.0 - (1.0 - d) ** steps
    sigma = np.sqrt(p_scatter * (1 - p_scatter) / R)
    assert abs(frac - p_scatter) < max(4 * sigma, 0.02), (
        f"scatter fraction {frac} vs expected {p_scatter}")
    # scatter points lie within the segment
    t = np.asarray(t_hit)[np.asarray(found)]
    assert (t >= np.asarray(tmin)[np.asarray(found)]).all()
    assert (t <= np.asarray(tmax)[np.asarray(found)] + 0.05).all()


def test_fog_occludes_shadow_rays():
    scene = _foggy_scene(density=5.0)
    scene = scene.replace(fog=scene.fog.replace(
        grid=jnp.ones_like(scene.fog.grid)))
    cfg = RenderConfig(dtype="float64")
    R = 512
    ro = jnp.stack([jnp.zeros(R), jnp.full(R, -1.0), jnp.zeros(R)], axis=1)
    rd = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (R, 3))
    occ = np.asarray(fog_occludes(scene, cfg, ro, rd, jnp.full(R, 9.0), 3))
    assert occ.mean() > 0.9, f"dense fog barely occludes: {occ.mean()}"


def test_foggy_render_end_to_end():
    """heightFog changes the image: fog brightens the view of a dark region
    (in-scattering) and the result stays finite."""
    scene = _foggy_scene(density=0.8)
    cfg = RenderConfig(min_samples=4, max_samples=4, max_depth=3,
                       dtype="float64", ambient=(0.0, 0.0, 0.0))
    cam = Camera(pos=(0.0, 1.0, -12.0), look_at=(0.0, 0.0, 0.0))
    img_fog = np.asarray(render_image(scene, cam, cfg, 24, 24))
    assert np.isfinite(img_fog).all()
    assert scene.has_fog

    clear = scene.replace(fog=None)
    assert not clear.has_fog
    img_clear = np.asarray(render_image(clear, cam, cfg, 24, 24))
    diff = np.abs(img_fog - img_clear).mean()
    assert diff > 1e-3, f"fog has no visible effect (mean diff {diff})"


def test_scn_heightfog_line_parses():
    """The commented heightFog template in caustics_02 (caustics.scn) parses
    and wires a Fog into the scene."""
    import tempfile, os
    scn = """colorTex 1 1 1
colorTex 0 0 0
mat 1 2 1 1 1
heightFog 0 .5 0 5 1 5 1 1 1 4 .5 4
light 0 5 0 4 4 4 .05
"""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "fog.scn")
        with open(path, "w") as f:
            f.write(scn)
        from gi_raytracer_tpu.scene import load_scene
        ls = load_scene(path)
    assert ls.scene.has_fog
    assert float(ls.scene.fog.density) == 4.0
    np.testing.assert_allclose(np.asarray(ls.scene.fog.color), [1, 1, 1])


def test_fog_chunked_waves_match_whole_frame():
    """Fog frames dispatch each wave in bounded lane chunks
    (cfg.fog_lane_chunk); chunking must be bitwise-invisible."""
    import numpy as np
    import jax.numpy as jnp
    from gi_raytracer_tpu.render.integrator import Renderer
    from gi_raytracer_tpu.render import Camera

    from gi_raytracer_tpu.config import RenderConfig
    scene = _foggy_scene()
    cfg = RenderConfig(min_samples=2, max_samples=2, adaptive=False,
                       max_depth=3, dtype="float64")
    cam = Camera(pos=(0.0, 2.0, -6.0), look_at=(0.0, 0.0, 0.0))
    r1 = Renderer(scene, cam, cfg.replace(fog_lane_chunk=0), 32, 32)
    img1 = np.asarray(r1.render())
    r2 = Renderer(scene, cam, cfg.replace(fog_lane_chunk=256), 32, 32)
    img2 = np.asarray(r2.render())
    np.testing.assert_array_equal(img2, img1)
