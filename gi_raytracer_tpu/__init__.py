"""gi_raytracer_tpu — a differentiable global-illumination path tracer in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
moepforfreedom/GI_Raytracer (a C++14/OpenMP CPU renderer): path-traced global
illumination with adaptive Halton QMC sampling, BVH-accelerated ray
intersection for triangles/spheres, Phong-style materials with image and
procedural textures, spherical area lights with soft shadows, reflection and
refraction, photon-mapped caustics with a kNN radiance estimate, and
atmospheric height fog — all as a wavefront renderer over flat SoA arrays,
differentiable end-to-end and sharded over device meshes.

Architecture (nothing here is a port — the reference is a recursive
pointer-chasing megakernel; this is a flat, array-oriented wavefront design):

  scene/      host-side scene compiler: .scn + OBJ -> flat arrays + BVH
  sampling/   Halton QMC engine (bit-compatible with the reference sampler)
  ops/        ray-primitive intersection and BVH traversal
  render/     wavefront integrator, shading, photon pass, atmosphere
  parallel/   device-mesh sharding of rays/photons, collectives
  io/         PNG output, checkpointing
"""

__version__ = "0.1.0"
