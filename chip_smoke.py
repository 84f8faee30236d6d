"""Smoke run of the renderer's main path on one GPU, at full size.

    python chip_smoke.py [--out DIR]     # one card
    python chip_smoke.py --four          # the sharded path on four cards

One process drives every phase (a JAX process reserves most of the card's
memory, so no second JAX process may share it).  Each phase prints one JSON
line with its name, its first-call seconds split into compile and steady
seconds, and its numbers; any failed check raises and the process exits
non-zero.  The last line is ``{"ok": true, "device": {...}}``.

One card, on the in-repo cornell scene (2,250 triangles, two spheres):

1. device:  refuse to run unless JAX's backend is the GPU; name the card.
2. scene:   the .scn parser, the OBJ loader and the BVH builder.
3. photons: the 750,000-photon caustic pass and map build.
4. trace:   the renderer's BVH traversal against a brute-force reference
            on 262,144 primary rays, one bounce of secondary rays and
            shadow rays.
5. knn:     both kNN estimators timed at 262,144 primary-hit points (k=32);
            the default one checked against a float64 run on 16,384.
6. render:  the 512x512, 8 spp, depth-8 frame with the map; then a 64x64
            frame rendered on the GPU and on the CPU backend.
7. cli:     ``cli render`` end to end at 128x128.
8. grad:    one value-and-grad step through the wavefront at 256x256,
            depth 8, with a 50,000-photon map and the chunk-row kNN.

``--four`` runs only what users shard (``cli render --devices N``) on four
cards, each part against its one-card equivalent: the photon pass, the
fused 512x512 render and the inverse-rendering train step.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(ROOT, "scenes", "cornell", "cornell.scn")


def emit(phase: str, **numbers) -> None:
    print(json.dumps({"phase": phase, **numbers}), flush=True)


def timed(fn, *args):
    """(result, timings): a first call (compilation + one run) and a
    second, steady call; compile_s is their difference."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    t2 = time.perf_counter()
    return out, {"compile_s": (t1 - t0) - (t2 - t1), "steady_s": t2 - t1}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip()


def phase_device(cards: int) -> dict:
    import jax
    from gi_raytracer_tpu.runtime import require_gpu

    info = require_gpu()
    check(info["count"] >= cards,
          f"need {cards} cards, JAX sees {info['count']}")
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, devices=[str(d) for d in jax.devices()],
         **info)
    return info


def phase_scene(path: str = SCENE):
    from gi_raytracer_tpu.native import get_lib
    from gi_raytracer_tpu.render import Camera
    from gi_raytracer_tpu.scene import load_scene

    t0 = time.perf_counter()
    ls = load_scene(path)
    dt = time.perf_counter() - t0
    cam = Camera(pos=ls.camera_pos, look_at=ls.camera_look_at)
    check(ls.scene.n_tris > 0, "scene has no triangles")
    emit("scene", tris=ls.scene.n_tris, spheres=ls.scene.n_spheres,
         lights=ls.scene.lights.count, native_bvh=get_lib() is not None,
         load_s=dt)
    return ls, cam


def phase_photons(ls, photons: int, min_stored: float = 0.99):
    """Emit ``photons`` slots and build the map; returns (batch, map)."""
    import numpy as np
    from gi_raytracer_tpu.render.photon import build_photon_map, trace_photons

    cfg = ls.config.replace(photons=photons)
    batch, t = timed(lambda: trace_photons(ls.scene, cfg))
    stored = int(np.asarray(batch.stored).sum())
    share = stored / photons
    t0 = time.perf_counter()
    pm = build_photon_map(batch, np.asarray(ls.scene.world_min),
                          np.asarray(ls.scene.world_max))
    build_s = time.perf_counter() - t0
    emit("photons", emitted=photons, stored=stored, stored_share=share,
         photons_per_s=photons / t["steady_s"], map_build_s=build_s,
         grid=list(pm.dims), window_cap=pm.window_cap, **t)
    check(share >= min_stored, f"stored share {share} < {min_stored}")
    return batch, pm


def primary_rays_of(ls, cam, width: int, height: int):
    """One wave of the renderer's own primary rays (block order)."""
    import jax.numpy as jnp
    import numpy as np
    from gi_raytracer_tpu.render.camera import primary_rays
    from gi_raytracer_tpu.render.integrator import Renderer

    cfg = ls.config.replace(min_samples=1, max_samples=1)
    r = Renderer(ls.scene, cam, cfg, width, height)
    idx = jnp.asarray(r.enum.index_image(0).ravel()[np.asarray(r._perm)])
    xr = r.sampler.sample(0, idx, r._index_bits).astype(jnp.float32)
    yr = r.sampler.sample(1, idx, r._index_bits).astype(jnp.float32)
    return primary_rays(cam, width, height, xr * r.enum.scale_x,
                        yr * r.enum.scale_y)


def phase_trace(ls, cam, width: int, height: int,
                min_agree: float = 0.999, rtol: float = 1e-4):
    """The renderer's traversal (as ``intersect_backend="auto"`` picks it)
    vs the brute-force reference.

    Tolerances: a ray through a shared triangle edge or a vertex may be
    claimed by either neighbour under a different rounding order, and two
    candidates at equal t tie-break by visiting order, so ``prim`` may
    differ on a few lanes (<= 0.1%); where both hit, the float32 t values
    of the two evaluation orders agree to 1e-4 relative."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gi_raytracer_tpu.ops.intersect import (closest_hit_brute,
                                                intersect_backend, trace_any,
                                                trace_closest_rows)
    from gi_raytracer_tpu.render.geom import hemisphere_cos, normalize
    from gi_raytracer_tpu.render.shading import (build_prim_rows,
                                                 shade_from_rows)
    from gi_raytracer_tpu.sampling.rng import hash_u01

    scene = ls.scene
    backend = intersect_backend(ls.config)
    rows = jax.jit(build_prim_rows)(scene)
    ro, rd = primary_rays_of(ls, cam, width, height)
    R = ro.shape[0]
    lane = jnp.arange(R, dtype=jnp.uint32)
    light = scene.lights.pos[0]

    @jax.jit
    def shipped(ro, rd):
        hit, row = trace_closest_rows(scene, rows, ro, rd, ray_id=lane,
                                      backend=backend)
        sh = shade_from_rows(scene, row, ro, rd, hit.t, hit.prim, hit.u,
                             hit.v)
        n = normalize(sh.normal)
        n = jnp.where(jnp.sum(n * rd, -1, keepdims=True) > 0, -n, n)
        o2 = sh.point + 1e-3 * n
        d2 = hemisphere_cos(n, hash_u01(lane, jnp.uint32(1), 0),
                            hash_u01(lane, jnp.uint32(2), 0), 1.0)
        act = hit.prim >= 0
        hit2, _ = trace_closest_rows(scene, rows, o2, d2, active=act,
                                     ray_id=lane, backend=backend)
        to_l = light[None, :] - o2
        dist = jnp.linalg.norm(to_l, axis=-1)
        occ = trace_any(scene, o2, to_l / dist[:, None], dist - 1e-3,
                        active=act, ray_id=lane, backend=backend)
        return hit, hit2, occ, o2, d2, to_l / dist[:, None], dist, act

    (hit, hit2, occ, o2, d2, ld, dist, act), t = timed(shipped, ro, rd)

    @jax.jit
    def reference(ro, rd, o2, d2, ld, dist, act):
        with jax.default_matmul_precision("highest"):
            h1 = closest_hit_brute(scene, ro, rd, ray_id=lane)
            h2 = closest_hit_brute(scene, o2, d2, active=act, ray_id=lane)
            occ = closest_hit_brute(scene, o2, ld, t_max=dist - 1e-3,
                                    active=act, ray_id=lane).prim >= 0
        return h1, h2, occ

    ref1, ref2, ref_occ = jax.block_until_ready(
        reference(ro, rd, o2, d2, ld, dist, act))

    def compare(a, b):
        pa, pb = np.asarray(a.prim), np.asarray(b.prim)
        both = (pa >= 0) & (pb >= 0)
        ta, tb = np.asarray(a.t)[both], np.asarray(b.t)[both]
        rel = float(np.max(np.abs(ta - tb) / np.maximum(np.abs(tb), 1e-6))
                    ) if both.any() else 0.0
        return float((pa == pb).mean()), rel, float((pb >= 0).mean())

    agree1, rel1, hit1 = compare(hit, ref1)
    agree2, rel2, hit2_share = compare(hit2, ref2)
    occ_agree = float((np.asarray(occ) == np.asarray(ref_occ)).mean())
    emit("trace", rays=R, traversal=backend, primary_prim_agree=agree1, primary_t_rel=rel1,
         primary_hit_share=hit1, secondary_prim_agree=agree2,
         secondary_t_rel=rel2, secondary_hit_share=hit2_share,
         shadow_agree=occ_agree, tolerance_prim=min_agree,
         tolerance_t_rel=rtol, **t)
    for name, v in (("primary", agree1), ("secondary", agree2),
                    ("shadow", occ_agree)):
        check(v >= min_agree, f"{name} agreement {v} < {min_agree}")
    for name, v in (("primary", rel1), ("secondary", rel2)):
        check(v <= rtol, f"{name} t relative error {v} > {rtol}")
    return ro, rd, hit


def phase_knn(ls, pm, ro, rd, hit, n_ref: int, max_rel: float = 1e-3):
    """Both kNN estimators at the primary-hit points; the default one
    against a float64 run of the per-point estimator.  The error is
    sum|est - ref| / sum|ref| over the reference slice."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gi_raytracer_tpu.render.photon import (sample_photons,
                                                sample_photons_backend)
    from gi_raytracer_tpu.scene.types import astype_tree

    k = ls.config.knn_k
    pts = ro + jnp.where(hit.prim >= 0, hit.t, 0.0)[:, None] * rd
    dirs = -rd
    out, times = {}, {}
    for backend in ("jnp", "chunkrow"):
        f = jax.jit(lambda p, d, b=backend: sample_photons_backend(
            pm, p, d, k, b))
        out[backend], times[backend] = timed(f, pts, dirs)
    auto = np.asarray(jax.jit(lambda p, d: sample_photons_backend(
        pm, p, d, k, "auto"))(pts[:n_ref], dirs[:n_ref]))

    with jax.enable_x64(True):
        pm64 = astype_tree(pm, jnp.float64)
        ref = np.asarray(jax.jit(lambda p, d: sample_photons(
            pm64, p, d, k))(pts[:n_ref].astype(jnp.float64),
                            dirs[:n_ref].astype(jnp.float64)))
    scale = max(float(np.abs(ref).sum()), 1e-30)
    err = {b: float(np.abs(np.asarray(out[b])[:n_ref] - ref).sum() / scale)
           for b in out}
    err_auto = float(np.abs(auto - ref).sum() / scale)
    R = pts.shape[0]
    emit("knn", points=R, k=k, ref_points=n_ref,
         occupied_share=float((np.abs(ref).sum(1) > 0).mean()),
         jnp_s=times["jnp"]["steady_s"],
         jnp_compile_s=times["jnp"]["compile_s"],
         chunkrow_s=times["chunkrow"]["steady_s"],
         chunkrow_compile_s=times["chunkrow"]["compile_s"],
         rel_err_auto=err_auto, rel_err_jnp=err["jnp"],
         rel_err_chunkrow=err["chunkrow"], tolerance=max_rel)
    check(err_auto <= max_rel, f"auto kNN error {err_auto} > {max_rel}")
    check(all(np.isfinite(np.asarray(o)).all() for o in out.values()),
          "non-finite kNN estimate")


def _wall_means(img):
    """Mean color of the left and right image margins (the side walls)."""
    H, W, _ = img.shape
    rows = slice(H // 4, 3 * H // 4)
    return (img[rows, :W // 6].mean(axis=(0, 1)),
            img[rows, -(W // 6):].mean(axis=(0, 1)))


def phase_render(ls, cam, pm, size: int, spp: int, depth: int,
                 out_png: str | None):
    """The full frame through Renderer.render, as ``cli render`` runs it."""
    import jax
    import numpy as np
    from gi_raytracer_tpu.io import save_png
    from gi_raytracer_tpu.render.integrator import Renderer

    cfg = ls.config.replace(min_samples=spp, max_samples=spp,
                            max_depth=depth)
    r = Renderer(ls.scene, cam, cfg, size, size, photon_map=pm)
    (img, st), t = timed(lambda: r.render(return_state=True))
    out = np.asarray(r.tonemap(img))
    rays = float(np.asarray(st["rays"]))
    stats = jax.devices()[0].memory_stats() or {}
    left, right = _wall_means(out)
    if out_png:
        save_png(out_png, out)
    emit("render", size=[size, size], spp=spp, depth=depth,
         photon_map=pm is not None, rays=rays,
         rays_per_s=rays / t["steady_s"],
         peak_bytes_in_use=stats.get("peak_bytes_in_use"),
         left_wall=left.tolist(), right_wall=right.tolist(),
         image_mean=float(out.mean()), **t)
    check(np.isfinite(out).all(), "non-finite pixels")
    check(out.mean() > 0.05, "image is black")
    check(left[0] > left[2], f"left wall not red: {left}")
    check(right[2] > right[0], f"right wall not blue: {right}")


def phase_render_cpu(ls, cam, pm, size: int, spp: int, depth: int,
                     bound: float = 0.02):
    """The same small frame on the default device and on the CPU backend.

    The default device renders with the traversal "auto" picks there (the
    Triton kernel on a GPU); the CPU has only the BVH walk, so its frame
    asks for that by name.

    Bound: XLA orders float sums differently per backend, and a last-bit
    change can flip a threshold decision (Russian roulette, the opacity and
    Fresnel lotteries, a grazing hit), which sends one path elsewhere.  A
    few flipped paths move the tonemapped image mean-abs by well under
    2e-2; a wrong kernel moves whole regions."""
    import jax
    import numpy as np
    from gi_raytracer_tpu.ops.intersect import intersect_backend
    from gi_raytracer_tpu.render.integrator import Renderer

    cfg = ls.config.replace(min_samples=spp, max_samples=spp,
                            max_depth=depth)
    imgs = []
    for dev, c in ((jax.devices()[0], cfg),
                   (jax.devices("cpu")[0], cfg.replace(
                       intersect_backend="jnp"))):
        with jax.default_device(dev):
            scene = jax.device_put(ls.scene, dev)
            pm_d = jax.device_put(pm, dev) if pm is not None else None
            r = Renderer(scene, cam, c, size, size, photon_map=pm_d)
            imgs.append(np.asarray(r.tonemap(r.render())))
    diff = float(np.abs(imgs[0] - imgs[1]).mean())
    emit("render_cpu_match", size=[size, size], spp=spp, depth=depth,
         device=jax.devices()[0].platform,
         traversal=intersect_backend(cfg), mean_abs_diff=diff, bound=bound)
    check(diff <= bound, f"GPU vs CPU mean abs diff {diff} > {bound}")


def phase_cli(out_dir: str, size: int, photons: int):
    """``cli render`` end to end, in this process."""
    from gi_raytracer_tpu import cli

    png = os.path.join(out_dir, "cornell_cli.png")
    t0 = time.perf_counter()
    cli.main(["render", SCENE, "-o", png, "-W", str(size), "-H", str(size),
              "--spp", "2", "--max-depth", "4", "--photons", str(photons)])
    dt = time.perf_counter() - t0
    check(os.path.getsize(png) > 0, "cli wrote no image")
    emit("cli", size=[size, size], photons=photons, seconds=dt)


def wave_inputs(ls, cam, cfg, size: int):
    """Primary rays and per-bounce samples of wave 0 (block order)."""
    import jax.numpy as jnp
    import numpy as np
    from gi_raytracer_tpu.render.camera import primary_rays
    from gi_raytracer_tpu.render.integrator import Renderer

    r = Renderer(ls.scene, cam, cfg, size, size)
    idx = jnp.asarray(r.enum.index_image(0).ravel()[np.asarray(r._perm)])
    xr = r.sampler.sample(0, idx, r._index_bits).astype(jnp.float32)
    yr = r.sampler.sample(1, idx, r._index_bits).astype(jnp.float32)
    ro, rd = primary_rays(cam, size, size, xr * r.enum.scale_x,
                          yr * r.enum.scale_y)
    sx, sy = r._bounce_samples(idx)
    return ro, rd, sx, sy


def phase_grad(ls, cam, batch, size: int, depth: int, n_map: int):
    """One inverse-rendering step: value_and_grad of an image loss with
    respect to the photon colors and the light color."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gi_raytracer_tpu.render.integrator import radiance_wave
    from gi_raytracer_tpu.render.photon import build_photon_map

    small = jax.tree_util.tree_map(lambda a: a[:n_map], batch)
    pm = build_photon_map(small, np.asarray(ls.scene.world_min),
                          np.asarray(ls.scene.world_max))
    cfg = ls.config.replace(min_samples=1, max_samples=1, max_depth=depth,
                            knn_backend="chunkrow")
    ro, rd, sx, sy = wave_inputs(ls, cam, cfg, size)
    lane = jnp.arange(ro.shape[0], dtype=jnp.uint32)
    key = jax.random.PRNGKey(0)
    target = jnp.full((ro.shape[0], 3), 0.25, jnp.float32)

    def loss_fn(pcol, lcol):
        sc = ls.scene.replace(lights=ls.scene.lights.replace(
            col=jnp.broadcast_to(lcol, ls.scene.lights.col.shape)))
        c = radiance_wave(sc, cfg, ro, rd, sx, sy, key, 0,
                          pm.replace(col=pcol), lane_ids=lane)
        return jnp.mean((c - target) ** 2)

    step = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))
    (loss, (g_pcol, g_lcol)), t = timed(step, pm.col,
                                        ls.scene.lights.col[0])
    norms = [float(jnp.linalg.norm(g_pcol)), float(jnp.linalg.norm(g_lcol))]
    emit("grad", size=[size, size], depth=depth, map_photons=n_map,
         knn="chunkrow", loss=float(loss), grad_norms=norms, **t)
    check(np.isfinite(float(loss)) and float(loss) > 0, f"loss {loss}")
    for name, g in (("photon colors", g_pcol), ("light color", g_lcol)):
        g = np.asarray(g)
        check(np.isfinite(g).all(), f"non-finite gradient to {name}")
        check((np.abs(g) > 0).any(), f"zero gradient to {name}")


def phase_four(ls, cam, n: int, size: int, spp: int, depth: int,
               photons: int, grad_size: int, tol: float = 1e-5):
    """What users shard, on ``n`` cards, against one card: the photon pass,
    the fused render and the train step.  Streams are keyed on global ids,
    so results agree up to float reassociation."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gi_raytracer_tpu.parallel import make_mesh, train_step_sharded
    from gi_raytracer_tpu.parallel.mesh import render_fused_sharded
    from gi_raytracer_tpu.render.integrator import Renderer
    from gi_raytracer_tpu.render.photon import (build_photon_map,
                                                trace_photons,
                                                trace_photons_sharded)

    mesh = make_mesh(n)
    one = make_mesh(1)
    # one chunk per card on the mesh == the same slot ranges on one card
    cfg = ls.config.replace(photons=photons, ray_chunk=photons // n,
                            min_samples=spp, max_samples=spp,
                            max_depth=depth)
    scene = ls.scene
    sharded, t_ph = timed(lambda: trace_photons_sharded(scene, cfg, mesh))
    single = trace_photons(scene, cfg)
    ph_err = float(np.max(np.abs(np.asarray(sharded.pos)
                                 - np.asarray(single.pos))))
    stored_same = bool(np.array_equal(np.asarray(sharded.stored),
                                      np.asarray(single.stored)))
    pm = build_photon_map(sharded, np.asarray(scene.world_min),
                          np.asarray(scene.world_max))

    r = Renderer(scene, cam, cfg, size, size, photon_map=pm)
    st, t_r = timed(lambda: render_fused_sharded(r, mesh))
    img_n = np.asarray(st["mean"])
    img_1 = np.asarray(r.render())
    render_err = float(np.max(np.abs(img_n - img_1)))

    cfg_g = cfg.replace(min_samples=1, max_samples=1)
    ro, rd, sx, sy = wave_inputs(ls, cam, cfg_g, grad_size)
    key = jax.random.PRNGKey(0)
    target = jnp.full(ro.shape, 0.25, ro.dtype)
    params = {"light_col": scene.lights.col,
              "tex_color": scene.textures.color}

    def rebuild(p):
        return scene.replace(
            lights=scene.lights.replace(col=p["light_col"]),
            textures=scene.textures.replace(color=p["tex_color"]))

    def train(m):
        with m:
            return jax.block_until_ready(train_step_sharded(
                m, params, rebuild, cfg_g, ro, rd, sx, sy, key, target))

    (loss_n, new_n), t_g = timed(lambda: train(mesh))
    loss_1, new_1 = train(one)
    grad_err = max(float(np.max(np.abs(np.asarray(new_n[k])
                                       - np.asarray(new_1[k]))))
                   for k in new_n)
    loss_err = abs(float(loss_n) - float(loss_1))
    emit("four", cards=n, photons=photons, photon_pos_max_abs_diff=ph_err,
         stored_identical=stored_same, photons_s=t_ph["steady_s"],
         photons_compile_s=t_ph["compile_s"], size=[size, size], spp=spp,
         depth=depth, render_max_abs_diff=render_err,
         render_s=t_r["steady_s"], render_compile_s=t_r["compile_s"],
         rays=float(st["rays"]), train_size=[grad_size, grad_size],
         train_loss_abs_diff=loss_err, train_param_max_abs_diff=grad_err,
         train_s=t_g["steady_s"], train_compile_s=t_g["compile_s"],
         tolerance=tol)
    check(stored_same, "sharded photon pass stored other slots")
    for name, v in (("photon", ph_err), ("render", render_err),
                    ("train loss", loss_err), ("train params", grad_err)):
        check(v <= tol, f"{name} max abs diff {v} > {tol}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the sharded path, on four cards")
    p.add_argument("--out", default=os.path.join(ROOT, "smoke_out"),
                   help="directory for the rendered images")
    args = p.parse_args(argv)

    from gi_raytracer_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    cards = 4 if args.four else 1
    info = phase_device(cards)
    os.makedirs(args.out, exist_ok=True)
    ls, cam = phase_scene()
    if args.four:
        phase_four(ls, cam, cards, size=512, spp=8, depth=8,
                   photons=ls.config.photons, grad_size=256)
    else:
        batch, pm = phase_photons(ls, ls.config.photons)
        ro, rd, hit = phase_trace(ls, cam, 512, 512)
        phase_knn(ls, pm, ro, rd, hit, n_ref=16_384)
        phase_render(ls, cam, pm, 512, 8, 8,
                     os.path.join(args.out, "cornell_512.png"))
        phase_render_cpu(ls, cam, pm, 64, 2, 4)
        phase_cli(args.out, 128, 50_000)
        phase_grad(ls, cam, batch, 256, 8, 50_000)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": cards}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
