"""Generate the in-repo cornell scene: ``scenes/cornell/cornell.scn`` and
the wall mesh it loads.

The layout follows the reference project's cornell box (white floor,
ceiling and back wall, red left wall, blue right wall, open front) at its
geometric budget: the reference ``box.obj`` held 2,192 triangles, here the
five walls are one 15x15-quad grid placed five times (2,250 triangles).
Inside stand a glass sphere that focuses the caustic, a glossy sphere and
a spherical area light.  Settings are the reference cornell's: a
750,000-photon map and a fixed 8 spp.

    python scripts/make_cornell.py [OUT_DIR]    # default: scenes/cornell
"""

from __future__ import annotations

import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from gi_raytracer_tpu.scene.meshgen import quad_mesh  # noqa: E402

HALF = 5.0      # box half-extent
GRID = 15       # quads per wall side


def wall_obj(n: int = GRID, half: float = HALF) -> str:
    """An n x n quad grid over [-half, half]^2 in the z=0 plane, as OBJ."""
    lines = [f"# {n}x{n}-quad wall, {2 * n * n} triangles"]
    step = 2.0 * half / n
    tris = []
    for i in range(n):
        for j in range(n):
            x0, y0 = -half + i * step, -half + j * step
            x1, y1 = x0 + step, y0 + step
            tris.extend(quad_mesh((x0, y0, 0), (x1, y0, 0),
                                  (x0, y1, 0), (x1, y1, 0)))
    for t in tris:
        for v in t:
            lines.append("v {:.6g} {:.6g} {:.6g}".format(*v))
    for k in range(len(tris)):
        a = 3 * k + 1
        lines.append(f"f {a} {a + 1} {a + 2}")
    return "\n".join(lines) + "\n"


def cornell_scn() -> str:
    q = math.pi / 2
    h = HALF
    walls = [  # (position, euler xyz rotation, material)
        ((0, 0, h), (0, 0, 0), 0),      # back
        ((0, -h, 0), (q, 0, 0), 0),     # floor
        ((0, h, 0), (q, 0, 0), 0),      # ceiling
        # the camera looks down +z with its right-hand side toward -x
        ((h, 0, 0), (0, q, 0), 1),      # left in the image, red
        ((-h, 0, 0), (0, q, 0), 2),     # right in the image, blue
    ]
    out = [
        "# Cornell box: see scripts/make_cornell.py, which writes this file",
        "photons 750000",
        "samples 8 8 0.0015",
        "colorTex 0.8 0.8 0.8",          # 0 white
        "colorTex 0.75 0.15 0.15",       # 1 red
        "colorTex 0.15 0.2 0.75",        # 2 blue
        "colorTex 0 0 0",                # 3 black (no emission)
        "colorTex 0.95 0.95 0.95",       # 4 sphere tint
        "mat 0 3 1 1",                   # 0 white diffuse
        "mat 1 3 1 1",                   # 1 red diffuse
        "mat 2 3 1 1",                   # 2 blue diffuse
        "mat 4 3 0 0 1.5",               # 3 glass
        "mat 4 3 0.05 1",                # 4 glossy
    ]
    for pos, rot, mat in walls:
        out.append("mesh wall.obj {} {} {} {:.7f} {:.7f} {:.7f} {}".format(
            *pos, *rot, mat))
    out += [
        "sphere 1.9 -3.5 0.2 1.5 3",     # glass, resting on the floor
        "sphere -2.3 -3.8 2.2 1.2 4",    # glossy
        "light 0 4.2 0 50 50 50 0.5",
        "camera 0 0 -12 0 -0.5 0",
    ]
    return "\n".join(out) + "\n"


def main(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "wall.obj"), "w") as f:
        f.write(wall_obj())
    with open(os.path.join(out_dir, "cornell.scn"), "w") as f:
        f.write(cornell_scn())


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "scenes",
        "cornell"))
