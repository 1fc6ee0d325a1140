"""Acceleration selection: brute-force matmul intersector vs BVH, per scene.

Small scenes (cornell-box, veach-mis, sphere/cube) use the Plücker matmul
intersector (ops/mxu_intersect.py) — dense and branch-free. Large meshes
(teapot, dragon) go through the SAH BVH's wavefront traversal. The emissive
pdf-set (usually a handful of primitives) always uses the brute-force path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Crossover from brute force to the BVH. Inherited, not measured on the
# H100 (ROADMAP D6).
MXU_MAX_TRIS = 4096


@dataclasses.dataclass
class SceneAccel:
    main: object = None        # MXUIntersector | BVH | None (pure spheres)
    emit: object = None        # MXUIntersector | None


def make_accel(buffers_np, config, mxu_max_tris: int = MXU_MAX_TRIS,
               force: Optional[str] = None) -> SceneAccel:
    from .bvh import build_bvh
    from .mxu_intersect import MXUIntersector

    accel = SceneAccel()
    if config.num_triangles > 0:
        if force == "bvh" or (force is None
                              and config.num_triangles > mxu_max_tris):
            accel.main = build_bvh(buffers_np["tri_p"]).to_device()
        else:
            accel.main = MXUIntersector(buffers_np["tri_p"]).to_device()
    if config.num_emit_triangles > 0:
        emit_tris = buffers_np["tri_p"][
            buffers_np["emit_tri_ids"][:config.num_emit_triangles]]
        accel.emit = MXUIntersector(emit_tris).to_device()
    return accel
