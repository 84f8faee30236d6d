"""Golden-image validation against the reference's OWN rendered outputs.

The reference ships renders for its bundled scenes (SURVEY §4: golden-image
eyeball testing).  Exact pixel equality is impossible by construction — the
reference is float64 C++ with wall-clock-seeded xorshift RNG (util.h:52-80)
and fastPow bit tricks — so these tests assert DOCUMENTED statistical
tolerances on the downsampled images:

* cornell (scenes/cornell/test.scn vs scenes/cornell/render.png): the
  checkout is missing dragon.obj (.MISSING_LARGE_BLOBS), so the golden
  contains a glass dragon our render cannot have; tolerances are set to
  absorb it (the dragon is transparent — measured contribution ~0.01 mean).
  Measured at 4 spp / no photons: mean 0.045, P95 0.100.
* caustics_02 (scenes/caustics_02/caustics.scn vs
  examples/caustics/test_16/render_7.5m.png — same scene, all assets
  present): measured mean 0.008, P95 0.040 at 2 spp / 20k photons.

Higher-fidelity side-by-sides (512px, full photon budgets) are
produced by scripts/validate_golden.py and committed under docs/validation/.
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # multi-minute golden renders (see --runslow)
from PIL import Image

import jax

from gi_raytracer_tpu.scene import load_scene
from gi_raytracer_tpu.render import Camera
from gi_raytracer_tpu.render.integrator import Renderer
from gi_raytracer_tpu.render.photon import trace_photons, build_photon_map

REF = "/root/reference"
SIZE = 128


def _render(scn, spp, depth, photons=0, size=SIZE):
    ls = load_scene(scn)
    cfg = ls.config.replace(min_samples=spp, max_samples=spp,
                            max_depth=depth, adaptive=False)
    pm = None
    if photons:
        cfg = cfg.replace(photons=photons)
        batch = trace_photons(ls.scene, cfg)
        pm = build_photon_map(batch, np.asarray(ls.scene.world_min),
                              np.asarray(ls.scene.world_max))
    cam = Camera(pos=ls.camera_pos, look_at=ls.camera_look_at)
    r = Renderer(ls.scene, cam, cfg, size, size, photon_map=pm)
    return np.asarray(r.tonemap(r.render()))


def _golden(path, size=SIZE):
    img = Image.open(path).convert("RGB").resize((size, size),
                                                 Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def _stats(img, gold):
    diff = np.abs(img - gold).mean(axis=-1)
    return float(diff.mean()), float(np.percentile(diff, 95))


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference not mounted")
def test_cornell_matches_reference_render():
    img = _render(f"{REF}/scenes/cornell/test.scn", spp=4, depth=6)
    gold = _golden(f"{REF}/scenes/cornell/render.png")
    mean, p95 = _stats(img, gold)
    # documented tolerance: 0.045/0.100 measured + headroom; the golden
    # includes the missing glass dragon and 750k-photon caustics
    assert mean < 0.065, f"cornell mean abs err {mean}"
    assert p95 < 0.14, f"cornell P95 abs err {p95}"
    # structural checks survive the tolerance: red box region is red
    box = img[58:82, 39:52]
    assert box[..., 0].mean() > 1.5 * box[..., 2].mean(), "red box missing"


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference not mounted")
def test_caustics02_matches_reference_render():
    img = _render(f"{REF}/scenes/caustics_02/caustics.scn", spp=2, depth=5,
                  photons=20000)
    gold = _golden(f"{REF}/examples/caustics/test_16/render_7.5m.png")
    mean, p95 = _stats(img, gold)
    # measured 0.008/0.040 at these settings + headroom
    assert mean < 0.02, f"caustics_02 mean abs err {mean}"
    assert p95 < 0.08, f"caustics_02 P95 abs err {p95}"


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference not mounted")
def test_glossy_cornell_matches_reference_render():
    """scenes/cornell/render_glossy.png — the only reference golden
    exercising the Phong-lobe roughness path (raytracer.h:360-378).

    No .scn for the glossy variant is committed upstream, so the scene is
    reconstructed from test.scn with the mirror sphere's roughness raised
    (the golden shows a frosted, blurred reflection).  Assertions:
    the glossy render must land CLOSER to the glossy golden than the
    mirror render does, and within a documented absolute tolerance."""
    import jax.numpy as jnp

    ls = load_scene(f"{REF}/scenes/cornell/test.scn")
    cfg = ls.config.replace(min_samples=4, max_samples=4, max_depth=6,
                            adaptive=False)
    cam = Camera(pos=ls.camera_pos, look_at=ls.camera_look_at)

    def render_with_rough(rough5):
        rough = ls.scene.materials.roughness
        scene = ls.scene.replace(materials=ls.scene.materials.replace(
            roughness=rough.at[5].set(rough5)))
        r = Renderer(scene, cam, cfg, SIZE, SIZE)
        return np.asarray(r.tonemap(r.render()))

    img_mirror = render_with_rough(0.0)
    img_glossy = render_with_rough(0.08)
    gold = _golden(f"{REF}/scenes/cornell/render_glossy.png")

    mean_g, p95_g = _stats(img_glossy, gold)
    mean_m, _ = _stats(img_mirror, gold)
    assert mean_g < mean_m, (
        f"glossy render no closer to glossy golden: {mean_g} vs {mean_m}")
    # absolute bound: golden includes the (missing) frosted dragon-side
    # sphere; tolerance documented from measured values + headroom
    assert mean_g < 0.075, f"glossy mean abs err {mean_g}"
    assert p95_g < 0.17, f"glossy P95 abs err {p95_g}"
    # the sphere's reflection must actually blur: local contrast inside
    # the sphere region drops versus the mirror render
    sph = np.s_[34:58, 38:62]
    var_m = img_mirror[sph].std()
    var_g = img_glossy[sph].std()
    assert var_g < var_m, (var_g, var_m)


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference not mounted")
def test_glass_matches_reference_render():
    """scenes/glass/render.png — the one bundled scene exercising image
    textures (sandstone.png 4x4) + deep refraction stacks + photons
    together (glass.scn:1-28).  Low-fidelity statistical check: 2 spp /
    5k photons vs the golden's converged 8-32spp / 275k; glass.obj (the
    stemware on the left) is MISSING from the checkout like dragon.obj,
    and the 95000-intensity light makes 2 spp firefly-noisy — measured
    mean 0.157, so the tolerance is 0.19."""
    img = _render(f"{REF}/scenes/glass/glass.scn", spp=2, depth=5,
                  photons=5000, size=96)
    gold = _golden(f"{REF}/scenes/glass/render.png", size=96)
    mean, _ = _stats(img, gold)
    assert np.isfinite(img).all()
    assert mean < 0.19, f"glass mean abs err {mean}"
    # structure that survives the noise: overall exposure matches, the
    # green glass ashtray region is green-dominant, and the sandstone
    # floor is warm (R > B) in both renders
    assert abs(img.mean() - gold.mean()) < 0.06, (img.mean(), gold.mean())
    ash = img[62:74, 40:58]
    assert ash[..., 1].mean() > ash[..., 2].mean(), "ashtray not green"
    floor = img[80:95, 8:60]
    gfloor = gold[80:95, 8:60]
    assert floor[..., 0].mean() > floor[..., 2].mean()
    assert gfloor[..., 0].mean() > gfloor[..., 2].mean()
