"""Gradient validation: analytic derivatives vs central finite differences.

The north-star requirement is that pixel gradients flow to MATERIAL,
TEXTURE, LIGHT and GEOMETRY parameters (the reference renderer,
include/raytracer.h, has no gradients at all — differentiability is the
headline capability this rebuild adds).  Each checker here differentiates
a small rendered image's mean intensity with respect to one parameter
family and compares against central finite differences on the SAME
deterministic estimator (counter-based RNG => identical stochastic
decisions on both sides of the FD step).

Discrete transport events (stochastic alpha, refract-vs-reflect lottery,
photon top-k selection) are detached by design; the checkers use smooth
configurations (closed diffuse geometry, fixed lotteries) where the
detached-sampling estimator is exact, so tolerances can be tight.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .config import RenderConfig
from .render.camera import Camera, primary_rays
from .render.integrator import Renderer, radiance_wave
from .render.geom import normalize


class GradReport(NamedTuple):
    name: str
    analytic: np.ndarray
    fd: np.ndarray
    rel_err: float

    @property
    def ok(self) -> bool:
        return self.rel_err < 1e-2


def _rel(g, fd):
    """Symmetric relative error; a ~0 true derivative with FD noise must not
    read as rel~1 against an analytic 0."""
    g = np.asarray(g, np.float64).ravel()
    fd = np.asarray(fd, np.float64).ravel()
    denom = np.maximum(np.maximum(np.abs(g), np.abs(fd)), 1e-3)
    return float(np.max(np.abs(g - fd) / denom))


def _fd_check(loss: Callable, param0, picks, eps) -> GradReport:
    """Central differences over the index tuples in ``picks``."""
    g = np.asarray(jax.grad(loss)(param0))
    fd = np.zeros(len(picks))
    ga = np.zeros(len(picks))
    for n, ix in enumerate(picks):
        e = jnp.zeros_like(param0).at[ix].set(eps)
        fd[n] = float((loss(param0 + e) - loss(param0 - e)) / (2 * eps))
        ga[n] = g[ix]
    return ga, fd


def _small_renderer(scene, cam, cfg, size=16):
    r = Renderer(scene, cam, cfg, size, size)
    idx = r.enum.index_image(0).ravel()
    return r, idx


def check_light_color(ls, size=16) -> GradReport:
    """d(image)/d(light color) — the inverse-lighting path."""
    cfg = ls.config.replace(adaptive=False, min_samples=1, max_samples=1,
                            max_depth=3)
    cam = Camera(pos=ls.camera_pos, look_at=ls.camera_look_at)
    r, idx = _small_renderer(ls.scene, cam, cfg, size)
    scene = ls.scene

    def loss(p):
        s = scene.replace(lights=scene.lights.replace(col=p))
        return jnp.mean(r._wave(s, None, idx, jnp.uint32(0)))

    p0 = scene.lights.col
    picks = [(i, c) for i in range(min(p0.shape[0], 2)) for c in range(3)]
    ga, fd = _fd_check(loss, p0, picks, 1e-2)
    return GradReport("light_col", ga, fd, _rel(ga, fd))


def check_texture_color(ls, size=16) -> GradReport:
    """d(image)/d(texture constant color) — the inverse-texture path."""
    cfg = ls.config.replace(adaptive=False, min_samples=1, max_samples=1,
                            max_depth=3)
    cam = Camera(pos=ls.camera_pos, look_at=ls.camera_look_at)
    r, idx = _small_renderer(ls.scene, cam, cfg, size)
    scene = ls.scene

    def loss(p):
        s = scene.replace(textures=scene.textures.replace(color=p))
        return jnp.mean(r._wave(s, None, idx, jnp.uint32(0)))

    p0 = scene.textures.color
    picks = [(i, c) for i in range(min(p0.shape[0], 3)) for c in range(3)]
    ga, fd = _fd_check(loss, p0, picks, 1e-2)
    return GradReport("texture_col", ga, fd, _rel(ga, fd))


def check_roughness(ls, size=16) -> GradReport:
    """d(image)/d(material roughness) — glossy-lobe + direct-light term."""
    cfg = ls.config.replace(adaptive=False, min_samples=1, max_samples=1,
                            max_depth=3)
    cam = Camera(pos=ls.camera_pos, look_at=ls.camera_look_at)
    r, idx = _small_renderer(ls.scene, cam, cfg, size)
    scene = ls.scene

    def loss(p):
        s = scene.replace(materials=scene.materials.replace(roughness=p))
        return jnp.mean(r._wave(s, None, idx, jnp.uint32(0)))

    p0 = scene.materials.roughness
    # only perturb glossy/diffuse materials (mirror/glass roughness<0.001
    # sits on the branch boundary raytracer.h:492)
    picks = [(int(i),) for i in np.nonzero(np.asarray(p0) > 0.01)[0][:4]]
    ga, fd = _fd_check(loss, p0, picks, 1e-3)
    return GradReport("roughness", ga, fd, _rel(ga, fd))


def check_ior(ls, size=16) -> GradReport:
    """d(image)/d(IOR) — refraction bending + Schlick fresnel."""
    cfg = ls.config.replace(adaptive=False, min_samples=1, max_samples=1,
                            max_depth=4)
    cam = Camera(pos=ls.camera_pos, look_at=ls.camera_look_at)
    r, idx = _small_renderer(ls.scene, cam, cfg, size)
    scene = ls.scene

    def loss(p):
        s = scene.replace(materials=scene.materials.replace(ior=p))
        return jnp.mean(r._wave(s, None, idx, jnp.uint32(0)))

    p0 = scene.materials.ior
    picks = [(int(i),) for i in np.nonzero(np.asarray(p0) > 1.0)[0][:2]]
    if not picks:
        return GradReport("ior", np.zeros(0), np.zeros(0), 0.0)
    ga, fd = _fd_check(loss, p0, picks, 1e-3)
    return GradReport("ior", ga, fd, _rel(ga, fd))


def check_vertices(ls, size=16, n_picks=4) -> GradReport:
    """d(image)/d(vertex positions): geometry gradients through the exact
    Möller–Trumbore recompute (v0/e1/e2/face_n rebuilt from a vertex
    tensor; the BVH stays frozen — the detached-structure estimator)."""
    cfg = ls.config.replace(adaptive=False, min_samples=1, max_samples=1,
                            max_depth=2)
    cam = Camera(pos=ls.camera_pos, look_at=ls.camera_look_at)
    r, idx = _small_renderer(ls.scene, cam, cfg, size)
    scene = ls.scene
    tr = scene.tris
    V0 = jnp.stack([tr.v0, tr.v0 + tr.e1, tr.v0 + tr.e2], axis=1)  # (T,3,3)

    def loss(V):
        v0 = V[:, 0]
        e1 = V[:, 1] - V[:, 0]
        e2 = V[:, 2] - V[:, 0]
        fn = jnp.cross(e1, e2)
        fn = fn / jnp.maximum(jnp.linalg.norm(fn, axis=-1, keepdims=True),
                              1e-30)
        s = scene.replace(tris=tr.replace(v0=v0, e1=e1, e2=e2, face_n=fn))
        return jnp.mean(r._wave(s, None, idx, jnp.uint32(0)))

    rng = np.random.default_rng(0)
    T = V0.shape[0]
    picks = [(int(rng.integers(T)), int(rng.integers(3)),
              int(rng.integers(3))) for _ in range(n_picks)]
    ga, fd = _fd_check(loss, V0, picks, 1e-4)
    return GradReport("vertices", ga, fd, _rel(ga, fd))


def check_camera(ls, size=16) -> GradReport:
    """d(image)/d(camera position) — sensor/primary-ray differentiability."""
    cfg = ls.config.replace(adaptive=False, min_samples=1, max_samples=1,
                            max_depth=2)
    cam = Camera(pos=ls.camera_pos, look_at=ls.camera_look_at)
    r, idx = _small_renderer(ls.scene, cam, cfg, size)
    scene = ls.scene
    sampler = r.sampler
    dt = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    idx_b = jnp.asarray(idx)[jnp.asarray(r._perm, jnp.int32)]
    xr = sampler.sample(0, idx_b, r._index_bits).astype(dt)
    yr = sampler.sample(1, idx_b, r._index_bits).astype(dt)
    sx_all, sy_all = r._bounce_samples(idx_b)
    key = jax.random.PRNGKey(0)

    def loss(campos):
        cam2 = Camera(pos=campos, look_at=jnp.asarray(ls.camera_look_at, dt))
        ro, rd = primary_rays(cam2, size, size,
                              xr * r.enum.scale_x, yr * r.enum.scale_y)
        c = radiance_wave(scene, cfg, ro, rd, sx_all, sy_all, key, 0, None)
        return jnp.mean(c)

    p0 = jnp.asarray(ls.camera_pos, dt)
    picks = [(0,), (1,), (2,)]
    ga, fd = _fd_check(loss, p0, picks, 1e-4)
    return GradReport("camera_pos", ga, fd, _rel(ga, fd))


def check_light_color_through_photons(scene, cfg) -> GradReport:
    """d(caustic estimate)/d(light color) THROUGH the photon pipeline:
    trace_photons (differentiable scan rounds) -> map rebind -> kNN Jensen
    estimate.  The exact boundary where gradients silently die if any stage
    detaches its inputs."""
    from .render.photon import trace_photons, build_photon_map, sample_photons

    cfg = cfg.replace(photon_retries=4)
    batch0 = trace_photons(scene, cfg)
    pm0 = build_photon_map(batch0, np.asarray(scene.world_min),
                           np.asarray(scene.world_max))
    q = jnp.asarray([[0.0, 0.0, 0.0], [0.5, 0.0, 0.5]], batch0.pos.dtype)
    d = jnp.asarray([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]], batch0.pos.dtype)

    def loss(lcol):
        s = scene.replace(lights=scene.lights.replace(col=lcol))
        batch = trace_photons(s, cfg, differentiable=True)
        pm = pm0.rebind(batch)
        return jnp.sum(sample_photons(pm, q, d, cfg.knn_k))

    p0 = scene.lights.col
    picks = [(0, c) for c in range(3)]
    ga, fd = _fd_check(loss, p0, picks, 1e-2)
    return GradReport("light_col_via_photon_map", ga, fd, _rel(ga, fd))


ALL_CHECKS = {
    "light_col": check_light_color,
    "texture_col": check_texture_color,
    "roughness": check_roughness,
    "ior": check_ior,
    "vertices": check_vertices,
    "camera_pos": check_camera,
}
