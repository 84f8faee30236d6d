"""Device-mesh distribution of the renderer.

The reference's only parallelism is OpenMP over image rows with a critical
section around the framebuffer (reference include/raytracer.h:93,154).  The
equivalent here is SPMD over a 1-D device mesh:

* rays / pixels / photons are sharded on their batch axis ('shard');
* the scene (triangles, BVH, materials, textures, photon map) is replicated
  in device memory on every card — tens of MB for the bundled scenes;
* gradients of replicated scene parameters are all-reduced by XLA
  automatically (pjit semantics);
* multi-host runs extend the same mesh via `jax.distributed.initialize`.

Nothing here hand-schedules collectives: shardings are annotated via
`NamedSharding` and XLA's SPMD partitioner inserts psum/all-gather — the
"pick a mesh, annotate, let XLA do the rest" recipe.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("shard",))


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> Mesh:
    """Multi-host entry: `jax.distributed.initialize` + global 1-D mesh.

    Each host calls this once before building scenes; the returned mesh
    spans every device of every host (the reference's whole "cluster" is
    one OpenMP process, raytracer.h:93 — here hosts cooperate with the same
    SPMD program).  With no arguments JAX reads the cluster from the
    environment, which works only where a cluster manager describes it;
    otherwise pass all three arguments.
    """
    kw = {}
    if coordinator_address is not None:
        kw = dict(coordinator_address=coordinator_address,
                  num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kw)
    return make_mesh()


def shard_batch(mesh: Mesh, tree: Any) -> Any:
    """Place a pytree of (R, ...) arrays sharded on axis 0."""
    def put(x):
        spec = P("shard", *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(put, tree)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Replicate a pytree (the scene) on every device of the mesh."""
    def put(x):
        return jax.device_put(x, NamedSharding(mesh, P()))
    return jax.tree_util.tree_map(put, tree)


def render_wave_sharded(mesh: Mesh, scene, cfg, ro, rd, sx_all, sy_all,
                        key, wave_salt, photon_map=None):
    """radiance_wave with rays sharded over the mesh, scene replicated.

    sx_all/sy_all are (D, R): sharded on the ray axis (axis 1).
    """
    from ..render.integrator import radiance_wave

    ro = jax.device_put(ro, NamedSharding(mesh, P("shard", None)))
    rd = jax.device_put(rd, NamedSharding(mesh, P("shard", None)))
    sx_all = jax.device_put(sx_all, NamedSharding(mesh, P(None, "shard")))
    sy_all = jax.device_put(sy_all, NamedSharding(mesh, P(None, "shard")))
    scene = replicate(mesh, scene)
    if photon_map is not None:
        photon_map = replicate(mesh, photon_map)

    fn = jax.jit(
        functools.partial(radiance_wave, cfg=cfg),
        static_argnames=(),
        out_shardings=NamedSharding(mesh, P("shard", None)))
    return fn(scene, ro=ro, rd=rd, sx_all=sx_all, sy_all=sy_all, key=key,
              wave_salt=wave_salt, photon_map=photon_map)


def train_step_sharded(mesh: Mesh, params, static_scene_fn, cfg,
                       ro, rd, sx_all, sy_all, key, target, lr=0.05,
                       photon_map=None):
    """One inverse-rendering SGD step, data-parallel over rays.

    ``params`` is a pytree of differentiable scene leaves (replicated);
    ``static_scene_fn(params) -> Scene`` rebuilds the scene around them.
    The L2 loss against ``target`` radiance is averaged over all (sharded)
    rays; XLA all-reduces the replicated-parameter gradients.
    Returns (loss, new_params).
    """
    from ..render.integrator import radiance_wave

    ro = jax.device_put(ro, NamedSharding(mesh, P("shard", None)))
    rd = jax.device_put(rd, NamedSharding(mesh, P("shard", None)))
    sx_all = jax.device_put(sx_all, NamedSharding(mesh, P(None, "shard")))
    sy_all = jax.device_put(sy_all, NamedSharding(mesh, P(None, "shard")))
    target = jax.device_put(target, NamedSharding(mesh, P("shard", None)))
    params = replicate(mesh, params)

    @jax.jit
    def step(params, ro, rd, sx_all, sy_all, target):
        def loss_fn(p):
            scene = static_scene_fn(p)
            c = radiance_wave(scene, cfg, ro, rd, sx_all, sy_all, key, 0,
                              photon_map)
            return jnp.mean((c - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        new = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
        return loss, new

    return step(params, ro, rd, sx_all, sy_all, target)


# --------------------------------------------------------------------------
# fully-sharded renderer: the fused adaptive while_loop, shard_map'd over
# image rows (the SPMD form of the reference's OpenMP row fan-out,
# raytracer.h:93 — but with a collective continue vote instead of a shared
# framebuffer critical section, raytracer.h:154)
# --------------------------------------------------------------------------

def render_fused_sharded(renderer, mesh: Mesh, state=None):
    """Run renderer's ENTIRE adaptive multi-wave render SPMD over ``mesh``.

    Pixels (image rows) are sharded; the scene and photon map are
    replicated; every stochastic stream is keyed on GLOBAL lane ids
    (radiance_wave's ``lane_base``), so the result is bit-identical to the
    single-device fused render (jnp backend).  Cross-device traffic per
    wave: one scalar psum (honest ray counter) + one scalar pmax (the
    adaptive-termination vote, the reference's per-pixel while condition
    raytracer.h:108 turned collective).

    Returns the final accumulation state (sharded image leaves).
    """
    from jax import shard_map
    from ..render.integrator import radiance_wave
    from ..render.camera import primary_rays
    from ..sampling.rng import Purpose, stream

    r = renderer
    cfg = r.cfg
    H, W = r.height, r.width
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]
    if H % n_dev or (H // n_dev) % 16:
        raise ValueError(f"height {H} must split into 16-row blocks over "
                         f"{n_dev} devices")
    Hs = H // n_dev
    lanes = Hs * W

    # local 16x16 block permutation for one shard's rows — identical
    # structure on every shard, so one host-side table serves all
    B = 16
    ids = np.arange(Hs * W).reshape(Hs, W)
    blocks = [ids[y:y + B, x:x + B].ravel()
              for y in range(0, Hs, B) for x in range(0, W, B)]
    perm = np.concatenate(blocks)
    inv_perm = np.argsort(perm).astype(np.int32)

    offsets = np.asarray(r.enum.offsets, np.uint32)         # (H, W) host
    inc = np.uint32(r.enum.increment)
    key_np = r._key
    scale_x, scale_y = float(r.enum.scale_x), float(r.enum.scale_y)
    index_bits = r._index_bits
    dt = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    def bounce_samples(idx):
        """(D, R_local) QMC pairs; identical to Renderer._bounce_samples for
        every practically-reachable depth (the reference's rand() fallback
        for dims>=256, raytracer.h:887, becomes a counter hash so shards
        can't correlate)."""
        from ..sampling.halton import MAX_QMC_DIMS
        from ..sampling.rng import hash_u01
        sx, sy = [], []
        for d in range(cfg.max_depth):
            for dim, acc in ((2 + 2 * d, sx), (3 + 2 * d, sy)):
                if dim < MAX_QMC_DIMS:
                    acc.append(r.sampler.sample(dim, idx, index_bits))
                else:
                    acc.append(hash_u01(idx, jnp.uint32(0x5EED0000 + dim)))
        return (jnp.stack(sx).astype(dt), jnp.stack(sy).astype(dt))

    state = state if state is not None else r.state0()
    state = dict(state, go=jnp.asarray(True))

    state_specs = {"mean": P(axis), "var": P(axis),
                   "samps": P(axis), "active": P(axis),
                   "wave": P(), "rays": P(), "go": P()}
    scene_specs = jax.tree_util.tree_map(lambda _: P(), r.scene)
    pm = r.photon_map
    pm_specs = (jax.tree_util.tree_map(lambda _: P(), pm)
                if pm is not None else None)

    N_total = H * W

    def body_fn(st, offsets_sh, scene, photon_map):
        shard_i = jax.lax.axis_index(axis)
        shard_base = shard_i.astype(jnp.uint32) * jnp.uint32(lanes)
        perm_j = jnp.asarray(perm, jnp.int32)
        inv_j = jnp.asarray(inv_perm, jnp.int32)

        def cond(st):
            return (st["wave"] < cfg.max_samples) & st["go"]

        def body(st):
            s = st["wave"]
            idx = (offsets_sh
                   + s.astype(jnp.uint32) * inc).ravel()[perm_j]
            xr = r.sampler.sample(0, idx, index_bits).astype(dt)
            yr = r.sampler.sample(1, idx, index_bits).astype(dt)
            ro, rd = primary_rays(r.camera, W, H,
                                  xr * scale_x, yr * scale_y)
            sx_all, sy_all = bounce_samples(idx)
            k = jax.random.fold_in(jnp.asarray(key_np),
                                   s.astype(jnp.uint32))
            # global lane id of (wave s, shard, local lane) must equal the
            # single-device id s*N + global_lane — see Renderer._wave_radiance
            out, (n_c, n_s) = radiance_wave(
                scene, cfg, ro, rd, sx_all, sy_all, k, 0, photon_map,
                with_counts=True,
                lane_base=s.astype(jnp.uint32) * jnp.uint32(N_total)
                + shard_base)
            c = out[inv_j].reshape(Hs, W, 3)
            st2 = r._accumulate(st, c, s)
            rays = st["rays"] + jax.lax.psum(
                (n_c + n_s).astype(jnp.float32), axis)
            go = jax.lax.pmax(
                jnp.any(st2["active"]).astype(jnp.int32), axis) > 0
            return dict(st2, rays=rays, go=go)

        return jax.lax.while_loop(cond, body, st)

    fn = shard_map(body_fn, mesh=mesh,
                   in_specs=(state_specs, P(axis), scene_specs, pm_specs),
                   out_specs=state_specs, check_vma=False)
    out = jax.jit(fn)(state, jnp.asarray(offsets), r.scene, pm)
    out.pop("go", None)
    return out
