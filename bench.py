"""Benchmark harness for one GPU.

Prints one JSON line per metric, each naming the device it ran on; the
LAST line is the headline metric:
  {"metric": "rays_per_s_cornell_512_8spp", "value": N, "unit": "rays/s",
   "vs_baseline": N, "device": {...}}

Protocol (BASELINE.md): the in-repo cornell scene (scenes/cornell) at
512x512, fixed 8 spp, depth 8, WITH the scene's 750k-photon caustic map —
the same work the reference's trace()/visible()/samplePhotons() do per
frame.  Refuses to run (exit non-zero) when JAX finds no GPU.

"Rays" counts every traversal query actually issued for an ALIVE lane —
primary + bounce extensions + shadow rays, from the integrator's own
per-bounce counters (PathState) — NOT a W*H*SPP*DEPTH*(1+L) formula:
paths killed by Russian roulette stop counting, exactly as the reference's
recursion stops issuing queries.

Also reported:
  photons_emitted_per_s  — wavefront emission pass throughput (750k slots)
  knn_gather_mphotons_per_s — photons returned by the kNN caustic estimate
    per second at 262k PRIMARY-HIT shading points (k=32)
  train_step_seconds — one value-and-grad step through the wavefront at
    256x256, 1 spp, depth 8, with a 50k-photon map and the chunk-row kNN
  rays_per_s_cornell_512_8spp_nophotons — the trace+shade-only number

vs_baseline divides by the measured reference: scripts/ref_baseline/
build_and_run.sh builds the reference headless and times the same
workload on CPU cores; BASELINE.json `measured_reference` holds the result
and its 32-core linear projection, which is the denominator; `vs_ref_host`
divides by the as-measured 2-core number.  That reference run rendered
the reference project's own cornell files; the in-repo scene matches their
triangle budget, photon count, resolution, spp and depth but not their
exact geometry, so vs_baseline compares like workloads, not identical ones.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

_BASE = json.load(open(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "BASELINE.json")))
REF_32CORE_RAYS_PER_S = _BASE["measured_reference"][
    "rays_per_s_32core_projected"]
REF_HOST_RAYS_PER_S = _BASE["measured_reference"]["rays_per_s_measured_2core"]

SCENE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes",
                     "cornell", "cornell.scn")
WIDTH = HEIGHT = 512
SPP = 8
DEPTH = 8
TRAIN_SIZE = 256
TRAIN_MAP = 50_000


def main():
    import jax
    import jax.numpy as jnp
    from gi_raytracer_tpu.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    dev = require_gpu()

    def report(**line):
        print(json.dumps({**line, "device": dev}), flush=True)

    from gi_raytracer_tpu.scene import load_scene
    from gi_raytracer_tpu.render import Camera
    from gi_raytracer_tpu.render.camera import primary_rays
    from gi_raytracer_tpu.render.integrator import Renderer, radiance_wave
    from gi_raytracer_tpu.render.photon import (trace_photons,
                                                build_photon_map,
                                                sample_photons_backend)
    from gi_raytracer_tpu.ops.intersect import trace_closest

    ls = load_scene(SCENE)
    cfg = ls.config.replace(min_samples=SPP, max_samples=SPP,
                            max_depth=DEPTH, adaptive=False)
    cam = Camera(pos=ls.camera_pos, look_at=ls.camera_look_at)

    # --- photon pass (the scene's 750k budget) ----------------------------
    batch = trace_photons(ls.scene, cfg)   # warmup+compile
    jax.block_until_ready(batch.pos)
    t0 = time.time()
    batch = trace_photons(ls.scene, cfg)
    jax.block_until_ready(batch.pos)
    dt_ph = time.time() - t0
    stored = int(np.asarray(batch.stored).sum())
    report(metric="photons_emitted_per_s", value=cfg.photons / dt_ph,
           unit="photons/s", stored=stored, seconds=dt_ph)

    pm = build_photon_map(batch, np.asarray(ls.scene.world_min),
                          np.asarray(ls.scene.world_max))

    # --- kNN gather throughput on REAL shading points ---------------------
    def wave_rays(r, size):
        idx = jnp.asarray(r.enum.index_image(0).ravel()[np.asarray(r._perm)])
        xr = r.sampler.sample(0, idx, r._index_bits).astype(jnp.float32)
        yr = r.sampler.sample(1, idx, r._index_bits).astype(jnp.float32)
        ro, rd = primary_rays(cam, size, size, xr * r.enum.scale_x,
                              yr * r.enum.scale_y)
        return idx, ro, rd

    R = WIDTH * HEIGHT
    _, ro, rd = wave_rays(Renderer(ls.scene, cam, cfg, WIDTH, HEIGHT), WIDTH)
    hit = jax.jit(lambda a, b: trace_closest(ls.scene, a, b))(ro, rd)
    pts = ro + jnp.where(hit.prim >= 0, hit.t, 0.0)[:, None] * rd
    dirs = -rd
    gather = jax.jit(lambda p, d: sample_photons_backend(
        pm, p, d, cfg.knn_k, cfg.knn_backend))
    jax.block_until_ready(gather(pts, dirs))  # warmup
    t0 = time.time()
    jax.block_until_ready(gather(pts, dirs))
    dt_g = time.time() - t0
    report(metric="knn_gather_mphotons_per_s",
           value=R * cfg.knn_k / dt_g / 1e6, unit="Mphotons/s", points=R,
           k=cfg.knn_k, seconds=dt_g, query_protocol="primary-hit")

    # --- backward pass: one inverse-rendering step -------------------------
    small = jax.tree_util.tree_map(lambda a: a[:TRAIN_MAP], batch)
    pm_small = build_photon_map(small, np.asarray(ls.scene.world_min),
                                np.asarray(ls.scene.world_max))
    N2 = TRAIN_SIZE * TRAIN_SIZE
    cfg2 = cfg.replace(min_samples=1, max_samples=1, knn_backend="chunkrow")
    rb = Renderer(ls.scene, cam, cfg2, TRAIN_SIZE, TRAIN_SIZE)
    idx2, ro2, rd2 = wave_rays(rb, TRAIN_SIZE)
    sx2, sy2 = rb._bounce_samples(idx2)
    lane2 = jnp.arange(N2, dtype=jnp.uint32)
    key2 = jax.random.PRNGKey(0)
    target = jnp.full((N2, 3), 0.25, jnp.float32)

    def loss_fn(pcol, lcol):
        pm_ = pm_small.replace(col=pcol)
        sc = ls.scene.replace(lights=ls.scene.lights.replace(
            col=jnp.broadcast_to(lcol, ls.scene.lights.col.shape)))
        c = radiance_wave(sc, cfg2, ro2, rd2, sx2, sy2, key2, 0, pm_,
                          lane_ids=lane2)
        return jnp.mean((c - target) ** 2)

    step = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))
    jax.block_until_ready(step(pm_small.col, ls.scene.lights.col[0]))
    t0 = time.time()
    lv, (g_pcol, g_lcol) = jax.block_until_ready(
        step(pm_small.col, ls.scene.lights.col[0]))
    dt_b = time.time() - t0
    report(metric="train_step_seconds", value=dt_b, unit="s",
           workload=f"cornell {TRAIN_SIZE}x{TRAIN_SIZE} 1spp wavefront, "
                    f"depth {DEPTH}, fwd+bwd, {TRAIN_MAP}-photon map, "
                    "knn=chunkrow; grads: photon colors + light color",
           loss=float(lv), grad_norms=[float(jnp.linalg.norm(g_pcol)),
                                       float(jnp.linalg.norm(g_lcol))])

    # --- render WITHOUT the map (trace+shade only) -------------------------
    r0 = Renderer(ls.scene, cam, cfg, WIDTH, HEIGHT)
    img, st = r0.render(return_state=True)
    np.asarray(img)
    t0 = time.time()
    img, st = r0.render(return_state=True)
    np.asarray(img)
    dt0 = time.time() - t0
    rays0 = float(np.asarray(st["rays"]))
    report(metric="rays_per_s_cornell_512_8spp_nophotons",
           value=rays0 / dt0, unit="rays/s", seconds=dt0,
           rays_traced=rays0)

    # --- full render WITH the 750k photon map (the headline) --------------
    r = Renderer(ls.scene, cam, cfg, WIDTH, HEIGHT, photon_map=pm)
    img, st = r.render(return_state=True)   # warmup
    np.asarray(img)
    t0 = time.time()
    img, st = r.render(return_state=True)
    np.asarray(img)
    dt = time.time() - t0
    rays = float(np.asarray(st["rays"]))
    report(metric="rays_per_s_cornell_512_8spp", value=rays / dt,
           unit="rays/s", vs_baseline=rays / dt / REF_32CORE_RAYS_PER_S,
           vs_ref_host=rays / dt / REF_HOST_RAYS_PER_S,
           baseline="measured 32-core projection "
                    f"{REF_32CORE_RAYS_PER_S:.3g} rays/s "
                    "(BASELINE.json measured_reference)",
           seconds=dt, rays_traced=rays, with_photon_map=True)


if __name__ == "__main__":
    main()
