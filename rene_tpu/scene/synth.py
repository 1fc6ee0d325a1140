"""Seeded in-repo stand-ins for scenes whose files are not shipped.

`CORNELL_BOX` is the committed stand-in for the reference's flagship scene
(36 triangles, 1024x1024). `mesh_scene_source` builds the big-mesh class (the
reference's teapot: one smooth mesh of ~10^5 triangles over a checker floor,
1280x720, maxdepth 65): a seeded lumpy lat-long sphere of
2*NU*(NV-1) triangles that the frontend refines with `Shape "loopsubdiv"`
(scene/assets/subdivision.py), 4^nlevels triangles per base triangle.
"""
from __future__ import annotations

import os

import numpy as np

SCENES_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scenes")
CORNELL_BOX = os.path.join(SCENES_DIR, "cornell-box.pbrt")

# base mesh resolution: 2 * 24 * 11 = 528 triangles; 4 levels -> 135,168
NU, NV = 24, 12


def blob_mesh(seed: int, radius: float = 1.0, bump: float = 0.12):
    """Lat-long sphere with seeded radial bumps. Returns (positions (V,3),
    indices (F*3,)), outward winding, poles shared."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, np.pi, NV + 1)[1:-1]          # rings
    phi = np.arange(NU) * (2.0 * np.pi / NU)
    t, f = np.meshgrid(theta, phi, indexing="ij")
    ring = np.stack([np.sin(t) * np.cos(f), np.sin(t) * np.sin(f),
                     np.cos(t)], axis=-1).reshape(-1, 3)
    dirs = np.concatenate([[[0.0, 0.0, 1.0]], ring, [[0.0, 0.0, -1.0]]])
    r = radius * (1.0 + bump * rng.standard_normal(len(dirs)))
    pos = dirs * r[:, None]

    top, bot = 0, len(dirs) - 1

    def vid(i, j):  # ring i in [0, NV-1), column j
        return 1 + i * NU + (j % NU)

    tris = [(top, vid(0, j), vid(0, j + 1)) for j in range(NU)]
    for i in range(NV - 2):
        for j in range(NU):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            tris += [(a, c, d), (a, d, b)]
    tris += [(bot, vid(NV - 2, j + 1), vid(NV - 2, j)) for j in range(NU)]
    return pos, np.asarray(tris, np.int64).reshape(-1)


def mesh_scene_source(seed: int = 0, nlevels: int = 4, xres: int = 1280,
                      yres: int = 720) -> str:
    """pbrt source of the big-mesh stand-in."""
    pos, idx = blob_mesh(seed)
    p = " ".join(f"{v:.6f}" for v in pos.reshape(-1))
    i = " ".join(str(int(v)) for v in idx)
    return f"""
Integrator "path" "integer maxdepth" [ 65 ]
LookAt 0 -5.2 2.1  0 0 0.8  0 0 1
Camera "perspective" "float fov" [ 35 ]
Film "image" "integer xresolution" [ {xres} ] "integer yresolution" [ {yres} ]
  "string filename" [ "mesh.png" ]
WorldBegin
LightSource "infinite" "rgb L" [ 0.55 0.6 0.7 ]
LightSource "distant" "point from" [ 2 -3 6 ] "point to" [ 0 0 0 ]
  "rgb L" [ 2.2 2.0 1.7 ]
AttributeBegin
  Texture "check" "spectrum" "checkerboard" "float uscale" [ 12 ]
    "float vscale" [ 12 ] "rgb tex1" [ 0.2 0.2 0.2 ] "rgb tex2" [ 0.75 0.75 0.75 ]
  Material "matte" "texture Kd" "check"
  Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
    "point P" [ -8 -8 0  8 -8 0  8 8 0  -8 8 0 ]
    "float uv" [ 0 0  1 0  1 1  0 1 ]
AttributeEnd
AttributeBegin
  Material "plastic" "rgb Kd" [ 0.45 0.12 0.08 ] "rgb Ks" [ 0.3 0.3 0.3 ]
    "float roughness" [ 0.05 ] "bool remaproughness" [ "false" ]
  Translate 0 0 1.05
  Shape "loopsubdiv" "integer nlevels" [ {nlevels} ]
    "integer indices" [ {i} ]
    "point P" [ {p} ]
AttributeEnd
WorldEnd
"""


def load_mesh_scene(seed: int = 0, nlevels: int = 4, xres: int = 1280,
                    yres: int = 720):
    """FlatScene of the big-mesh stand-in (2 floor + 528 * 4^nlevels
    mesh triangles)."""
    from ..pbrt import parse_pbrt
    from .flatten import create_scene
    return create_scene(parse_pbrt(mesh_scene_source(seed, nlevels, xres,
                                                     yres)), SCENES_DIR)
