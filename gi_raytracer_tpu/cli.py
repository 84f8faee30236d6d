"""Command-line interface.

The reference's "CLI" is one positional scene-file argument into a Qt GUI
(reference main.cpp:36-39).  Here: subcommands for rendering, photon-pass
inspection, gradient checking and benchmarking, PNG output, checkpointing.

  python -m gi_raytracer_tpu.cli render scenes/cornell/cornell.scn -o out.png
  python -m gi_raytracer_tpu.cli bench  scenes/cornell/cornell.scn
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _build(args):
    from .scene import load_scene
    from .render import Camera

    t0 = time.time()
    ls = load_scene(args.scene)
    cfg = ls.config
    if args.spp:
        cfg = cfg.replace(min_samples=args.spp, max_samples=args.spp)
    if args.max_depth:
        cfg = cfg.replace(max_depth=args.max_depth)
    if args.photons is not None:
        cfg = cfg.replace(photons=args.photons)
    cam = Camera(pos=ls.camera_pos, look_at=ls.camera_look_at)
    print(f"[scene] {ls.scene.n_tris} tris, {ls.scene.n_spheres} spheres, "
          f"{ls.scene.lights.count} lights ({time.time() - t0:.2f}s)")
    return ls, cfg, cam


def _photon_map(ls, cfg, devices: int = 1):
    from .render.photon import trace_photons, build_photon_map

    if cfg.photons <= 0 or ls.scene.lights.count == 0:
        return None
    t0 = time.time()
    if devices > 1:
        from .parallel import make_mesh
        from .render.photon import trace_photons_sharded
        count = cfg.photons - (cfg.photons % devices)
        batch = trace_photons_sharded(ls.scene, cfg, make_mesh(devices),
                                      count=count)
    else:
        batch = trace_photons(ls.scene, cfg)
    stored = int(np.asarray(batch.stored).sum())
    pm = build_photon_map(batch, np.asarray(ls.scene.world_min),
                          np.asarray(ls.scene.world_max))
    print(f"[photons] {stored}/{batch.stored.shape[0]} stored "
          f"({time.time() - t0:.2f}s)")
    return pm if stored else None


def cmd_render(args):
    from .render.integrator import Renderer
    from .io import save_png
    from .io.checkpoint import save_checkpoint, load_checkpoint
    from .runtime import device_info

    if args.distributed:
        # multi-host entry (jax.distributed.initialize) — every host runs
        # this same command; the mesh spans all devices of all hosts
        from .parallel import init_distributed
        init_distributed()
    dev = device_info()
    print(f"[device] platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']}")

    ls, cfg, cam = _build(args)
    pm = _photon_map(ls, cfg, devices=args.devices) \
        if not args.no_photons else None
    r = Renderer(ls.scene, cam, cfg, args.width, args.height, photon_map=pm)

    if args.devices > 1 or args.distributed:
        import jax
        from .parallel import make_mesh
        from .parallel.mesh import render_fused_sharded
        n = args.devices if args.devices > 1 else len(jax.devices())
        mesh = make_mesh(n)
        t0 = time.time()
        st = render_fused_sharded(r, mesh)
        out = np.asarray(r.tonemap(st["mean"]))
        print(f"[render] {time.time() - t0:.2f}s sharded over {n} devices "
              f"({float(st['rays']):.3g} rays)")
        save_png(args.output, out)
        print(f"[out] {args.output}")
        return

    import hashlib
    with open(args.scene, "rb") as f:
        scene_hash = hashlib.sha1(f.read()).hexdigest()[:16]
    meta = {"width": args.width, "height": args.height, "seed": cfg.seed,
            "min_samples": cfg.min_samples, "max_samples": cfg.max_samples,
            "max_depth": cfg.max_depth, "scene_sha1": scene_hash}

    state = None
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        import jax.numpy as jnp
        raw = load_checkpoint(args.checkpoint, expect_meta=meta)
        raw.pop("meta", None)
        state = {k: jnp.asarray(v) for k, v in raw.items()}
        print(f"[resume] wave {int(state['wave'])} from {args.checkpoint}")

    def on_wave(st, s):
        # incremental display + crash-safe accumulation (the reference's
        # progressive repaint, viewer.h:16-61, plus the checkpoint/resume
        # the reference lacks)
        if args.preview:
            save_png(args.preview, np.asarray(r.tonemap(st["mean"])))
        if args.checkpoint:
            save_checkpoint(args.checkpoint, meta=meta,
                            **{k: np.asarray(v) for k, v in st.items()})
        if args.verbose:
            print(f"[wave {s}] active {int(np.asarray(st['active']).sum())}")

    hook = on_wave if (args.preview or args.checkpoint) else None
    t0 = time.time()
    if args.profile:
        import jax
        with jax.profiler.trace(args.profile):
            img, st = r.render(verbose=args.verbose, on_wave=hook,
                               state=state, return_state=True)
            out = np.asarray(r.tonemap(img))
        print(f"[profile] xplane trace written to {args.profile}")
    else:
        img, st = r.render(verbose=args.verbose, on_wave=hook, state=state,
                           return_state=True)
        out = np.asarray(r.tonemap(img))
    dt = time.time() - t0
    rays = float(np.asarray(st["rays"]))
    if rays > 0:   # fused path tracks honest per-bounce counters
        print(f"[render] {dt:.2f}s — {rays:.3g} rays traced "
              f"({rays / dt / 1e6:.2f} Mrays/s honest)")
    else:          # host-stepped preview path has no counters
        paths = args.width * args.height * cfg.max_samples
        print(f"[render] {dt:.2f}s ({paths / dt / 1e6:.2f} Mpaths/s "
              f"upper bound)")
    save_png(args.output, out)
    print(f"[out] {args.output}")


def cmd_photons(args):
    ls, cfg, cam = _build(args)
    _photon_map(ls, cfg)


def cmd_grad_check(args):
    """Validate renderer gradients against central finite differences for
    EVERY differentiable parameter family (north star: material, texture,
    light, geometry + camera).  Prints one JSON line per family.
    """
    from . import gradcheck

    ls, cfg, cam = _build(args)
    ls.config = cfg
    size = max(16, min(args.width, 64))
    for name, fn in gradcheck.ALL_CHECKS.items():
        if name == "light_col" and ls.scene.lights.count == 0:
            continue  # ambient-only scenes (e.g. examples/test_scene)
        try:
            rep = fn(ls, size=size)
        except Exception as e:  # report, keep checking the rest
            print(json.dumps({"metric": f"grad_rel_err_{name}",
                              "error": str(e)[:200], "pass": False}))
            continue
        print(json.dumps({"metric": f"grad_rel_err_{name}",
                          "value": rep.rel_err,
                          "analytic": np.asarray(rep.analytic).tolist(),
                          "fd": np.asarray(rep.fd).tolist(),
                          "pass": bool(rep.ok)}))


def cmd_bench(args):
    """Timed fixed-spp render; prints one JSON line per metric."""
    from .render.integrator import Renderer

    ls, cfg, cam = _build(args)
    cfg = cfg.replace(adaptive=False,
                      min_samples=args.spp or 8, max_samples=args.spp or 8)
    pm = _photon_map(ls, cfg) if not args.no_photons else None
    r = Renderer(ls.scene, cam, cfg, args.width, args.height, photon_map=pm)
    img = r.render()  # warmup+compile
    np.asarray(img)
    t0 = time.time()
    img = r.render()
    np.asarray(img)
    dt = time.time() - t0
    spp = cfg.max_samples
    primary = args.width * args.height * spp
    print(json.dumps({"metric": "primary_paths_per_s",
                      "value": primary / dt, "unit": "paths/s",
                      "seconds": dt, "spp": spp,
                      "size": [args.width, args.height]}))


def main(argv=None):
    from .runtime import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="gi_raytracer_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("render", cmd_render), ("photons", cmd_photons),
                     ("bench", cmd_bench), ("grad-check", cmd_grad_check)):
        sp = sub.add_parser(name)
        sp.add_argument("scene")
        sp.add_argument("-o", "--output", default="render.png")
        sp.add_argument("-W", "--width", type=int, default=512)
        sp.add_argument("-H", "--height", type=int, default=512)
        sp.add_argument("--spp", type=int, default=0,
                        help="fixed samples/pixel (0 = scene adaptive)")
        sp.add_argument("--max-depth", type=int, default=0)
        sp.add_argument("--photons", type=int, default=None)
        sp.add_argument("--no-photons", action="store_true")
        sp.add_argument("--devices", type=int, default=1,
                        help="shard render+photons over N local devices")
        sp.add_argument("--distributed", action="store_true",
                        help="multi-host: jax.distributed.initialize + "
                             "mesh over every chip of every host")
        sp.add_argument("--preview", default=None, metavar="PNG",
                        help="write a tonemapped preview after every wave")
        sp.add_argument("--checkpoint", default=None, metavar="NPZ",
                        help="save accumulation state after every wave")
        sp.add_argument("--resume", action="store_true",
                        help="resume from --checkpoint if it exists")
        sp.add_argument("--profile", default=None, metavar="DIR",
                        help="capture a jax.profiler trace of the render")
        sp.add_argument("-v", "--verbose", action="store_true")
        sp.set_defaults(fn=fn)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
