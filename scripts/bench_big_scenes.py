"""Traversal timing on the GPU: closest-hit plus shadow any-hit for 262,144
camera rays, on the in-repo cornell scene and on a seeded wavy terrain of
about 1M triangles.

    python scripts/bench_big_scenes.py [--tris N] [--seed S]
        [--backends jnp,triton] [--frame]

Prints one JSON line per (scene, traversal) with the device and the
card's name and power limit beside the times.  Refuses to run without a
GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402


def terrain_scene(n: int, seed: int = 0):
    """(n-1)^2*2-triangle wavy terrain with seeded wave phases, + a light."""
    from gi_raytracer_tpu.scene.build import SceneBuilder

    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 2 * np.pi, 4)
    b = SceneBuilder()
    white = b.add_texture_const((0.8, 0.8, 0.8))
    black = b.add_texture_const((0.0, 0.0, 0.0))
    m = b.add_material(white, black, 1.0, 1.0, 1.0)
    xs = np.linspace(-20, 20, n)
    X, Z = np.meshgrid(xs, xs)
    Y = (1.5 * np.sin(X * 0.7 + ph[0]) * np.cos(Z * 0.6 + ph[1])
         + 0.3 * np.sin(X * 2.3 + ph[2]) * np.sin(Z * 1.9 + ph[3]))
    P = np.stack([X, Y, Z], -1)                      # (n, n, 3)
    a = P[:-1, :-1]; bb = P[:-1, 1:]; c = P[1:, :-1]; d = P[1:, 1:]
    t1 = np.stack([a, bb, c], 2).reshape(-1, 3, 3)
    t2 = np.stack([bb, d, c], 2).reshape(-1, 3, 3)
    tris = np.concatenate([t1, t2], 0)
    b._tri_v.extend(list(tris))
    b._tri_n.extend([np.zeros((3, 3))] * len(tris))
    b._tri_uv.extend([np.zeros((3, 2))] * len(tris))
    b._tri_mat.extend([m] * len(tris))
    b.add_light((0.0, 25.0, 0.0), (600.0, 600.0, 600.0), 1.0)
    return b.build(dtype=np.float32)


def trace_fn(scene, backend: str):
    """jit(rays -> (closest hit, shadow occlusion)) for one traversal."""
    import jax
    import jax.numpy as jnp
    from gi_raytracer_tpu.ops.intersect import trace_any, trace_closest_rows
    from gi_raytracer_tpu.render.geom import normalize
    from gi_raytracer_tpu.render.shading import build_prim_rows

    rows = jax.jit(build_prim_rows)(scene)

    @jax.jit
    def f(scene, rows, ro, rd):
        light = scene.lights.pos[0]
        lane = jnp.arange(ro.shape[0], dtype=jnp.uint32)
        hit, _ = trace_closest_rows(scene, rows, ro, rd, ray_id=lane,
                                    backend=backend)
        act = hit.prim >= 0
        p = ro + jnp.where(act, hit.t, 0.0)[:, None] * rd - 1e-3 * rd
        to_l = light[None, :] - p
        dist = jnp.linalg.norm(to_l, axis=-1)
        occ = trace_any(scene, p, normalize(to_l), dist - 1e-3,
                        active=act, ray_id=lane, backend=backend)
        return hit.prim, occ

    return lambda ro, rd: f(scene, rows, ro, rd)


def camera_rays(cam, size: int):
    import jax.numpy as jnp
    from gi_raytracer_tpu.render.camera import primary_rays

    g = (jnp.arange(size, dtype=jnp.float32) + 0.5)
    dx = jnp.tile(g, size)
    dy = jnp.repeat(g, size)
    return primary_rays(cam, size, size, dx, dy)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tris", type=int, default=1_000_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--size", type=int, default=512,
                   help="rays per trace = size^2")
    p.add_argument("--frame", action="store_true",
                   help="also time full Renderer frames per backend")
    p.add_argument("--backends", default="jnp",
                   help="comma-separated traversal backends to time: "
                        "jnp, triton")
    args = p.parse_args(argv)

    import jax
    from gi_raytracer_tpu.render import Camera
    from gi_raytracer_tpu.runtime import enable_compile_cache, require_gpu
    from gi_raytracer_tpu.scene import load_scene

    enable_compile_cache()
    dev = require_gpu()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    ls = load_scene(os.path.join(root, "scenes", "cornell", "cornell.scn"))
    n = int(round(np.sqrt(args.tris / 2))) + 1
    t0 = time.perf_counter()
    terrain = terrain_scene(n, args.seed)
    build_s = time.perf_counter() - t0
    scenes = (
        ("cornell", ls.scene,
         Camera(pos=ls.camera_pos, look_at=ls.camera_look_at)),
        (f"terrain_seed{args.seed}", terrain,
         Camera(pos=(0.0, 18.0, -30.0), look_at=(0.0, 0.0, 0.0))),
    )
    backends = [b for b in args.backends.split(",") if b]
    for name, scene, cam in scenes:
        ro, rd = camera_rays(cam, args.size)
        first_prim = None
        for backend in backends:
            f = trace_fn(scene, backend)
            t0 = time.perf_counter()
            jax.block_until_ready(f(ro, rd))
            first = time.perf_counter() - t0
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                prim, occ = jax.block_until_ready(f(ro, rd))
                times.append(time.perf_counter() - t0)
            if first_prim is None:
                first_prim, first_occ = np.asarray(prim), np.asarray(occ)
            print(json.dumps({
                "metric": "trace_closest_plus_shadow_s", "scene": name,
                "prim_agree_with_first": float(np.mean(
                    np.asarray(prim) == first_prim)),
                "occ_agree_with_first": float(np.mean(
                    np.asarray(occ) == first_occ)),
                "tris": scene.n_tris, "rays": int(ro.shape[0]),
                "backend": backend, "seconds": times,
                "median_s": float(np.median(times)),
                "first_call_s": first,
                "hit_share": float(np.mean(np.asarray(prim) >= 0)),
                "occluded_share": float(np.mean(np.asarray(occ))),
                "scene_build_s": build_s if name != "cornell" else None,
                "device": dev, "card": card}), flush=True)
    if args.frame:
        frames(ls, scenes[1][1], scenes[1][2], backends, dev, card)


def frames(ls, terrain, terrain_cam, backends, dev, card):
    """Renderer frames per traversal backend, in turns (A, B, B, A): the
    cornell 512x512, 8 spp, depth-8 frame with its 750k-photon map, and a
    256x256, 2 spp, depth-3 terrain frame without photons."""
    import jax
    from gi_raytracer_tpu.render import Camera
    from gi_raytracer_tpu.render.integrator import Renderer
    from gi_raytracer_tpu.render.photon import build_photon_map, trace_photons

    batch = trace_photons(ls.scene, ls.config)
    pm = build_photon_map(batch, np.asarray(ls.scene.world_min),
                          np.asarray(ls.scene.world_max))
    cells = (
        ("cornell_512_8spp_d8_map", ls.scene,
         Camera(pos=ls.camera_pos, look_at=ls.camera_look_at),
         ls.config.replace(min_samples=8, max_samples=8, max_depth=8), pm,
         512),
        ("terrain_256_2spp_d3", terrain, terrain_cam,
         ls.config.replace(min_samples=2, max_samples=2, max_depth=3,
                           photons=0, adaptive=False), None, 256),
    )
    for name, scene, cam, cfg, pmap, size in cells:
        rs = {b: Renderer(scene, cam, cfg.replace(intersect_backend=b),
                          size, size, photon_map=pmap) for b in backends}
        first = {}
        for b in backends:
            t0 = time.perf_counter()
            jax.block_until_ready(rs[b].render())
            first[b] = time.perf_counter() - t0
        times = {b: [] for b in backends}
        for b in backends + backends[::-1]:
            t0 = time.perf_counter()
            img, st = rs[b].render(return_state=True)
            jax.block_until_ready(img)
            times[b].append(time.perf_counter() - t0)
        imgs = {b: np.asarray(rs[b].render()) for b in backends}
        b0 = backends[0]
        for b in backends:
            print(json.dumps({
                "metric": "frame_s", "cell": name, "backend": b,
                "seconds": times[b], "first_call_s": first[b],
                "rays": float(st["rays"]),
                "mean_abs_diff_vs_first": float(np.abs(
                    imgs[b] - imgs[b0]).mean()),
                "device": dev, "card": card}), flush=True)


if __name__ == "__main__":
    main()
