"""Parser for the reference's ``.scn`` scene DSL (sceneLoader.cpp:12-185).

Grammar (line-oriented, whitespace-separated):

  imTex <file> <utile> <vtile>
  checkerboardTex <ar> <ag> <ab> <br> <bg> <bb> <tiles>
  colorTex <r> <g> <b>
  mat <diffuse_tex> <emissive_tex> <roughness> <opacity> [<IOR>]
  multiMat <i> <j> ...            (parsed but unused, like the reference)
  mesh <file.obj> <px py pz> <rx ry rz> <mat>
  sphere <px py pz> <rad> <mat>
  cone <px py pz> <rx ry rz> <rad> <height> <mat>   (extension)
  box <px py pz> <sx sy sz> <rx ry rz> <mat>
  light <px py pz> <r g b> <rad>
  heightFog <px py pz> <sx sy sz> <r g b> <density> <scatter> <scale>
  photons <count> <depth>
  samples <min> <max> <noise_thresh>
  ambient <r> <g> <b>
  camera <px py pz> <lx ly lz>

Returns the compiled device Scene plus camera/config overrides.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..config import RenderConfig
from .build import SceneBuilder
from .objio import load_obj
from .meshgen import box_mesh


@dataclasses.dataclass
class LoadedScene:
    scene: "object"             # gi_raytracer_tpu.scene.types.Scene
    config: RenderConfig
    camera_pos: tuple
    camera_look_at: tuple


def _load_image_rgba(path: str) -> tuple[np.ndarray, bool]:
    """Image file -> (H, W, 4) linear-space float RGBA + has_alpha flag.
    De-gamma (2.2) happens here once, vs per-fetch in the reference
    (material.h:67)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"imTex {path!r} needs Pillow to decode the image; install "
            "pillow or use colorTex/checkerboardTex") from e

    im = Image.open(path)
    has_alpha = im.mode in ("RGBA", "LA", "PA")
    im = im.convert("RGBA")
    arr = np.asarray(im, np.float32) / 255.0
    arr[..., :3] = arr[..., :3] ** 2.2
    return arr, has_alpha


def load_scene(path: str, base_config: RenderConfig | None = None,
               dtype=np.float32) -> LoadedScene:
    cfg = base_config or RenderConfig()
    b = SceneBuilder()
    scene_dir = os.path.dirname(os.path.abspath(path))
    camera_pos = (10.0, 5.0, 0.0)       # main.cpp:28 default
    camera_look_at = (0.0, 0.0, 0.0)
    overrides: dict = {}

    with open(path, "r") as f:
        tokens: list[str] = []
        for line in f:
            line = line.split("#", 1)[0]
            tokens.extend(line.split())

    i = 0

    def take(n):
        nonlocal i
        out = tokens[i:i + n]
        i += n
        return out

    def _is_num(t: str) -> bool:
        try:
            float(t)
            return True
        except ValueError:
            return False

    def take_nums(max_n):
        """Up to max_n numeric tokens — the fscanf format lists in the
        reference stop silently at the first non-numeric token
        (e.g. `photons 750000` with no depth, `mat` with 4 args)."""
        nonlocal i
        out = []
        while len(out) < max_n and i < len(tokens) and _is_num(tokens[i]):
            out.append(float(tokens[i]))
            i += 1
        return out

    while i < len(tokens):
        key = tokens[i]; i += 1
        if key == "imTex":
            fn, ut, vt = take(3)
            img, has_alpha = _load_image_rgba(os.path.join(scene_dir, fn))
            b.add_texture_image(img, (float(ut), float(vt)), has_alpha)
        elif key == "checkerboardTex":
            v = [float(x) for x in take(7)]
            b.add_texture_checker(int(v[6]), v[0:3], v[3:6])
        elif key == "colorTex":
            v = [float(x) for x in take(3)]
            b.add_texture_const(v)
        elif key == "mat":
            v = take_nums(5)
            ior = v[4] if len(v) > 4 else 1.0
            b.add_material(int(v[0]), int(v[1]), v[2], v[3], ior)
        elif key == "multiMat":
            # parsed but never consumed (sceneLoader.cpp:84-107)
            while i < len(tokens) and tokens[i].lstrip("-").isdigit():
                i += 1
        elif key == "mesh":
            v = take(8)
            fn = v[0]
            pos = tuple(float(x) for x in v[1:4])
            rot = tuple(float(x) for x in v[4:7])
            mat = int(v[7])
            p = os.path.join(scene_dir, fn)
            if not os.path.exists(p):
                raise FileNotFoundError(f"{path}: mesh {fn!r} not found at {p}")
            tv, tn, tuv = load_obj(p, pos, rot)
            b.add_triangles(tv, tn, tuv, mat)
        elif key == "sphere":
            v = take(5)
            b.add_sphere(tuple(float(x) for x in v[0:3]), float(v[3]), int(v[4]))
        elif key == "cone":
            # extension: analytic cone (the reference exposes the primitive,
            # entities.h:144-299, but its .scn grammar never did)
            v = take(9)
            b.add_cone(tuple(float(x) for x in v[0:3]),
                       tuple(float(x) for x in v[3:6]),
                       float(v[6]), float(v[7]), int(v[8]))
        elif key == "box":
            v = take(10)
            tris = box_mesh([float(x) for x in v[0:3]],
                            [float(x) for x in v[3:6]],
                            [float(x) for x in v[6:9]])
            b.add_triangles(tris, None, None, int(v[9]))
        elif key == "light":
            v = [float(x) for x in take(7)]
            b.add_light(v[0:3], v[3:6], v[6])
        elif key == "heightFog":
            v = [float(x) for x in take(12)]
            b.add_height_fog(v[0:3], v[3:6], v[6:9], v[9], v[10], v[11],
                             seed=cfg.seed)
        elif key == "photons":
            v = take_nums(2)
            overrides["photons"] = int(v[0])
            if len(v) > 1:
                overrides["photon_depth"] = int(v[1])
        elif key == "samples":
            v = take(3)
            overrides["min_samples"] = int(v[0])
            overrides["max_samples"] = int(v[1])
            overrides["noise_thresh"] = float(v[2])
        elif key == "ambient":
            v = [float(x) for x in take(3)]
            overrides["ambient"] = tuple(v)
        elif key == "camera":
            v = [float(x) for x in take(6)]
            camera_pos = tuple(v[0:3])
            camera_look_at = tuple(v[3:6])
        else:
            raise ValueError(f"unknown .scn keyword: {key!r}")

    cfg = cfg.replace(**overrides) if overrides else cfg
    scene = b.build(dtype=dtype)
    return LoadedScene(scene=scene, config=cfg,
                       camera_pos=camera_pos, camera_look_at=camera_look_at)
