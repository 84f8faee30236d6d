"""Execution-strategy equivalence: the renderer's result must not depend on
HOW the work is scheduled (fused device loop vs host-stepped waves, batched
vs single waves) — only on the deterministic sample streams."""

import numpy as np
import jax
import jax.numpy as jnp

from gi_raytracer_tpu.config import RenderConfig
from gi_raytracer_tpu.render import Camera
from gi_raytracer_tpu.render.integrator import Renderer, radiance_wave
import __graft_entry__ as ge


def _setup(**kw):
    scene = ge._tiny_scene(np.float32)
    cfg = RenderConfig(min_samples=2, max_samples=4, max_depth=3, **kw)
    cam = Camera(pos=(0.0, 0.0, -14.0), look_at=(0.0, 0.0, 0.0))
    return scene, cfg, cam


def test_fused_loop_matches_host_loop():
    """One jitted on-device while_loop over waves (the default path) must
    produce exactly the host-stepped per-wave loop's accumulation state."""
    scene, cfg, cam = _setup()
    r = Renderer(scene, cam, cfg, 48, 48)
    fused, st_f = r.render(return_state=True)
    hosted, st_h = r.render(on_wave=lambda st, s: None, return_state=True)
    # the two paths are separately compiled XLA programs; fusion choices
    # may reassociate float math by 1 ULP — tolerance is a few ULPs, the
    # CONTROL FLOW (waves run, samples counted, active masks) must be exact
    np.testing.assert_allclose(np.asarray(fused), np.asarray(hosted),
                               rtol=0, atol=1e-6)
    assert int(st_f["wave"]) == int(st_h["wave"])
    np.testing.assert_array_equal(np.asarray(st_f["samps"]),
                                  np.asarray(st_h["samps"]))
    np.testing.assert_array_equal(np.asarray(st_f["active"]),
                                  np.asarray(st_h["active"]))


def test_wave_batching_matches_single_waves():
    """wave_size=B traces B waves as one (B*N)-lane wavefront; globally
    unique lane ids make it bitwise the same estimator as B separate
    waves (modulo XLA reassociation)."""
    scene, cfg1, cam = _setup()
    cfg1 = cfg1.replace(wave_size=1)
    cfgB = cfg1.replace(wave_size=4)
    r1 = Renderer(scene, cam, cfg1, 32, 32)
    rB = Renderer(scene, cam, cfgB, 32, 32)
    assert rB._wave_batch == 4 and r1._wave_batch == 1
    img1, st1 = r1.render(return_state=True)
    imgB, stB = rB.render(return_state=True)
    np.testing.assert_allclose(np.asarray(img1), np.asarray(imgB),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(st1["samps"]),
                                  np.asarray(stB["samps"]))


def test_block_adaptive_skips_converged_blocks():
    """Adaptive waves must trace ONLY still-active 16x16 blocks: with one
    active block, a wave's honest ray count is a small fraction of a full
    wave (the reference stops per-pixel work, raytracer.h:108-148)."""
    import jax.numpy as jnp
    scene, cfg, cam = _setup()
    cfg = cfg.replace(min_samples=2, max_samples=8, adaptive=True,
                      max_depth=3)
    r = Renderer(scene, cam, cfg, 64, 64)
    st = r.state0()
    full = r._block_adaptive_wave(scene, None, st)
    full_rays = float(full["rays"])

    one = r.state0()
    act = np.zeros((64, 64), bool)
    act[0:16, 0:16] = True
    one["active"] = jnp.asarray(act)
    out = r._block_adaptive_wave(scene, None, one)
    few_rays = float(out["rays"])
    assert few_rays < 0.3 * full_rays, (few_rays, full_rays)
    assert few_rays > 0


def test_lane_base_offsets_streams():
    """radiance_wave(lane_base=k) must equal slicing a wider wave at [k:] —
    the property the sharded renderer relies on."""
    scene, cfg, cam = _setup()
    r = Renderer(scene, cam, cfg, 16, 16)
    ro, rd, sx, sy, key = ge._make_wave_inputs(r)
    full = radiance_wave(scene, cfg, ro, rd, sx, sy, key, 0, None)
    half = ro.shape[0] // 2
    lo = radiance_wave(scene, cfg, ro[:half], rd[:half],
                       sx[:, :half], sy[:, :half], key, 0, None, lane_base=0)
    hi = radiance_wave(scene, cfg, ro[half:], rd[half:],
                       sx[:, half:], sy[:, half:], key, 0, None,
                       lane_base=half)
    np.testing.assert_array_equal(np.asarray(full[:half]), np.asarray(lo))
    np.testing.assert_array_equal(np.asarray(full[half:]), np.asarray(hi))
