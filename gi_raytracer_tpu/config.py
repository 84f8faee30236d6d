"""Renderer configuration.

The reference scatters its tuning knobs over three tiers: compile-time
``#define`` s (reference include/util.h:14-31), mutable public fields on the
renderer (reference include/raytracer.h:721-726) and per-scene ``.scn``
overrides (reference include/sceneLoader.cpp:160-179).  Here everything lives
in one frozen dataclass; scene files produce an updated copy.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # --- geometry / numerics (util.h:18-21) ---
    epsilon: float = 1e-5            # EPSILON
    shadow_bias: float = 1e-4        # SHADOW_BIAS

    # --- path tracing depths (util.h:22-23) ---
    min_depth: int = 2               # MIN_DEPTH: bounces before Russian roulette
    max_depth: int = 16              # reference MAX_DEPTH=64; RR kills paths far
                                     # earlier, 16 validated against convergence

    # --- adaptive QMC sampling (util.h:24-26, raytracer.h:723-725) ---
    min_samples: int = 8             # MIN_SAMPLES
    max_samples: int = 32            # SAMPLES
    noise_thresh: float = 0.0015     # NOISE_THRESH
    adaptive: bool = True            # min==max or False disables adaptivity
    wave_size: int = 1               # fixed-spp waves traced per fused-loop
                                     # iteration as one wider wavefront

    # --- photon mapping (util.h:27-28, raytracer.h:721-722) ---
    photons: int = 75_000            # PHOTONS
    photon_depth: int = 5            # PHOTON_DEPTH
    photon_retries: int = 64         # reference retries each emission slot up
                                     # to 500x serially (raytracer.h:602); here
                                     # retries are masked re-emission ROUNDS in
                                     # a while_loop that exits as soon as all
                                     # slots stored, so the cap is cheap; 64
                                     # leaves P(all-fail) negligible for any
                                     # per-attempt success rate >= 10%
    knn_k: int = 32                  # photon gather size (raytracer.h:258)
    caustic_max_depth: int = 10      # photon lookup depth gate (raytracer.h:258)

    # --- atmosphere (util.h:29) ---
    raymarch_stepsize: float = 0.04  # RAYMARCH_STEPSIZE
    raymarch_max_steps: int = 512    # static bound for lax.scan
    fog_lane_chunk: int = 32768      # fog waves dispatch in lane chunks of
                                     # this size, bounding each device
                                     # program's (lanes x 512-step raymarch
                                     # x D bounces) working set
                                     # (0 = whole-frame waves)

    # --- camera & output (util.h:30-31, camera.h:4,29-30) ---
    focal_blur: float = 0.0          # FOCAL_BLUR
    gamma: float = 2.2               # GAMMA
    ambient: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    # --- execution ---
    dtype: str = "float32"           # compute dtype ("float32"|"float64")
    intersect_backend: str = "auto"  # triangle traversal: "auto"|"jnp"|
                                     # "triton" (see
                                     # ops.intersect.intersect_backend)
    knn_backend: str = "auto"        # photon kNN gather: "auto"|"jnp"|
                                     # "chunkrow" (see
                                     # photon.sample_photons_backend)
    ray_chunk: int = 1 << 17         # rays per device dispatch
    seed: int = 0                    # base PRNG seed (deterministic runs)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()
