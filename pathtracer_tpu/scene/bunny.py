"""Stanford bunny scene (BASELINE config 3: bunny mesh via OBJ + LBVH).

The reference ships ``models/bunny/bunny.obj`` (2,503 v / 4,968 f) but never
loads it — the only call site is commented out (``main.cu:534``). This scene
wires it up: the bunny mesh over a grey ground sphere under the sky light,
with a mirror and a glass sphere flanking it for bounce variety.
"""
from __future__ import annotations

import os
from typing import Tuple

from pathtracer_tpu.config import K_ASPECT_RATIO
from pathtracer_tpu.core.camera import Camera, make_camera
from pathtracer_tpu.io.obj import load_obj
from pathtracer_tpu.scene.scene import Scene, SceneBuilder

# Vendored asset: a grid-cluster decimation of the public-domain Stanford
# bunny scan (1,817 v / 3,616 f), derived by tools/make_bunny_asset.py and
# committed under assets/ so the flagship scene is pinned by the repo.
ASSET_OBJ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "assets", "bunny.obj")


def resolve_bunny_obj() -> str | None:
    """Resolution order: PT_BUNNY_OBJ env > vendored assets/bunny.obj. None
    only when both are missing (the procedural stand-in then applies)."""
    env = os.environ.get("PT_BUNNY_OBJ")
    for p in (env, ASSET_OBJ):
        if p and os.path.exists(p):
            return p
    return None


def subdivide_faces(verts, faces, levels: int = 1):
    """4:1 midpoint subdivision, ``levels`` times (numpy, host).

    Splits every triangle into four at its edge midpoints — the surface
    is unchanged (no smoothing), only the triangle count quadruples, so a
    level-k bunny is the *same geometry* at 4^k x the primitive count:
    the honest scaling workload for the sub-linear closest-hit
    (tools/bench_prim_scaling.py --bunny). Emits unshared triangle soup
    (vertex dedup is irrelevant to the SoA intersection tables)."""
    import numpy as np
    for _ in range(levels):
        a = verts[faces[:, 0]]
        b = verts[faces[:, 1]]
        c = verts[faces[:, 2]]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        tris = np.concatenate([
            np.stack([a, ab, ca], axis=1),
            np.stack([ab, b, bc], axis=1),
            np.stack([ca, bc, c], axis=1),
            np.stack([ab, bc, ca], axis=1),
        ], axis=0)                                  # (4F, 3, 3)
        verts = tris.reshape(-1, 3)
        faces = np.arange(verts.shape[0], dtype=np.int64).reshape(-1, 3)
    return verts, faces


def bunny_world(obj_path: str | None = None, scale: float = 20.0,
                material: str = "lambertian",
                subdivide: int = 0) -> Tuple[Scene, Camera]:
    if obj_path is None:
        obj_path = resolve_bunny_obj()
    if obj_path is not None and os.path.exists(obj_path):
        verts, faces = load_obj(obj_path)
    else:
        # no env / vendored asset at all: procedural stand-in
        # keeps the flagship mesh pipeline runnable; images differ from
        # the Stanford bunny (scene/standalone_assets.py)
        import sys
        from pathtracer_tpu.scene.standalone_assets import bunny_standin
        print(f"bunny_world: {obj_path} not found - using the procedural "
              "stand-in mesh (set PT_BUNNY_OBJ for the Stanford bunny)",
              file=sys.stderr)
        verts, faces = bunny_standin()
    verts = verts * scale
    if subdivide:
        verts, faces = subdivide_faces(verts, faces, subdivide)
    # center on origin, rest on y=0
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    verts = verts - (lo + hi) / 2.0
    verts[:, 1] -= verts[:, 1].min()

    b = SceneBuilder()
    if material == "metal":
        bunny_mat = b.add_metal((0.8, 0.7, 0.55), 0.05)
    elif material == "dielectric":
        bunny_mat = b.add_dielectric(1.5)
    else:
        bunny_mat = b.add_lambertian((0.65, 0.55, 0.45))
    b.add_mesh(verts, faces, bunny_mat)

    ground = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0, -1000, 0), 1000.0, ground)
    mirror = b.add_metal((0.7, 0.6, 0.5), 0.0)
    b.add_sphere((-4.5, 1.5, -1.0), 1.5, mirror)
    glass = b.add_dielectric(1.5)
    b.add_sphere((4.5, 1.5, -1.0), 1.5, glass)

    cam = make_camera((0, 3.0, 9.0), (0, 1.5, 0), 35, K_ASPECT_RATIO,
                      aperture=0, focus_dist=10, time0=0.0, time1=1.0)
    return b.build(), cam
