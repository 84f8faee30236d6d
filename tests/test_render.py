"""End-to-end render tests on the in-repo cornell scene (cheap sizes)."""

import os

import numpy as np
import pytest

from gi_raytracer_tpu.scene import load_scene, SceneBuilder
from gi_raytracer_tpu.render import Camera
from gi_raytracer_tpu.render.integrator import Renderer, render_image

CORNELL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes", "cornell", "cornell.scn")


@pytest.fixture(scope="module")
def cornell():
    return load_scene(CORNELL)


def test_cornell_renders_with_expected_wall_colors(cornell):
    cam = Camera(pos=cornell.camera_pos, look_at=cornell.camera_look_at)
    cfg = cornell.config.replace(min_samples=4, max_samples=4, max_depth=3)
    img = np.asarray(render_image(cornell.scene, cam, cfg, 32, 32))
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    assert img.mean() > 0.05, "image black"
    # left wall is red-dominant, right wall blue-dominant (cornell.scn mats 1/2)
    left = img[8:24, :6].mean(axis=(0, 1))
    right = img[8:24, -6:].mean(axis=(0, 1))
    assert left[0] > left[2], f"left wall not red: {left}"
    assert right[2] > right[0], f"right wall not blue: {right}"


def test_adaptive_sampling_extends_noisy_pixels(cornell):
    cam = Camera(pos=cornell.camera_pos, look_at=cornell.camera_look_at)
    cfg = cornell.config.replace(min_samples=2, max_samples=8,
                                 noise_thresh=0.0015, max_depth=3)
    r = Renderer(cornell.scene, cam, cfg, 16, 16)
    img = np.asarray(r.render())
    assert np.isfinite(img).all()


def test_ambient_on_miss():
    b = SceneBuilder()
    t0 = b.add_texture_const((1, 1, 1))
    m = b.add_material(t0, t0, 1.0, 1.0)
    b.add_triangle([(100, 100, 100), (101, 100, 100), (100, 101, 100)],
                   mat_id=m)
    scene = b.build(dtype=np.float64)
    from gi_raytracer_tpu.config import RenderConfig
    cfg = RenderConfig(min_samples=1, max_samples=1, max_depth=2,
                       ambient=(0.25, 0.5, 0.75), dtype="float64")
    cam = Camera(pos=(0, 0, -5), look_at=(0, 0, 0))
    img = np.asarray(render_image(scene, cam, cfg, 8, 8))
    expected = np.array([0.25, 0.5, 0.75]) ** (1 / 2.2)
    np.testing.assert_allclose(img, np.broadcast_to(expected, (8, 8, 3)),
                               atol=1e-6)


def test_emissive_surface_visible():
    b = SceneBuilder()
    black = b.add_texture_const((0, 0, 0))
    em = b.add_texture_const((2.0, 1.0, 0.5))
    m = b.add_material(black, em, 1.0, 1.0)
    # big emissive wall facing the camera
    b.add_triangle([(-50, -50, 5), (50, -50, 5), (0, 80, 5)], mat_id=m)
    scene = b.build(dtype=np.float64)
    from gi_raytracer_tpu.config import RenderConfig
    cfg = RenderConfig(min_samples=1, max_samples=1, max_depth=2,
                       dtype="float64")
    cam = Camera(pos=(0, 0, -5), look_at=(0, 0, 0))
    img = np.asarray(render_image(scene, cam, cfg, 8, 8))
    center = img[4, 4]
    expected = np.clip(np.array([2.0, 1.0, 0.5]), 0, None) ** (1 / 2.2)
    np.testing.assert_allclose(center, np.clip(expected, 0, 1), atol=1e-5)


def test_render_differentiable_wrt_light_color(cornell):
    """Pixel gradients flow to scene parameters (here: light color)."""
    import jax
    import jax.numpy as jnp

    cam = Camera(pos=cornell.camera_pos, look_at=cornell.camera_look_at)
    cfg = cornell.config.replace(min_samples=1, max_samples=1, max_depth=2)
    r = Renderer(cornell.scene, cam, cfg, 8, 8)
    idx = r.enum.index_image(0).ravel()

    def loss(lcol):
        scene = cornell.scene.replace(
            lights=cornell.scene.lights.replace(col=lcol))
        c = r._wave(scene, None, idx, jnp.uint32(0))
        return jnp.sum(c)

    g = jax.grad(loss)(cornell.scene.lights.col)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert (np.abs(g) > 0).any(), "zero gradient to light color"
