"""Cornell box scene from the reference's shipped (never-loaded) OBJ assets
(``models/cornellbox/*.obj`` — floor, left, right, light, shortbox, tallbox;
SURVEY §2.1 La row). Lit by the emissive area light; black background
(BASELINE configs 1-2).
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from pathtracer_tpu.core.camera import Camera, make_camera
from pathtracer_tpu.io.obj import load_obj
from pathtracer_tpu.scene.scene import Scene, SceneBuilder

# optional directory of the Cornell OBJ parts; unset -> built-in data
CORNELL_DIR = os.environ.get("PT_CORNELL_DIR")
MARBLE_PNG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))),
    "assets", "textures", "marble.png")


def _cornell_part(obj_dir: str, name: str):
    """(verts, faces) for a Cornell part: the OBJ in ``obj_dir`` when given,
    else the built-in canonical data (the published Cornell box dataset;
    scene/standalone_assets.py)."""
    if obj_dir:
        return load_obj(os.path.join(obj_dir, name + ".obj"))
    from pathtracer_tpu.scene.standalone_assets import cornell_mesh
    return cornell_mesh(name)


def add_cornell_room(b: SceneBuilder, obj_dir: str = CORNELL_DIR):
    """Add the Cornell room meshes (floor+ceiling+back, red left, green
    right, emissive ceiling light) to a builder. Returns the white material
    id for reuse. Shared by cornell_box and presets.combined_scene."""
    white = b.add_lambertian((0.73, 0.73, 0.73))
    red = b.add_lambertian((0.65, 0.05, 0.05))
    green = b.add_lambertian((0.12, 0.45, 0.15))
    light = b.add_emissive((15.0, 15.0, 15.0))
    for name, mat in (("floor", white), ("left", red), ("right", green),
                      ("light", light)):
        verts, faces = _cornell_part(obj_dir, name)
        b.add_mesh(verts, faces, mat)
    return white


def cornell_box(obj_dir: str = CORNELL_DIR, aspect: float = 1.0,
                variant: str = "full") -> Tuple[Scene, Camera]:
    """Cornell box. ``variant``:

    - "spheres": diffuse spheres instead of the boxes (BASELINE config 1),
    - "full": boxes + a metal and a glass sphere (config 2 materials).
    """
    b = SceneBuilder()
    white = add_cornell_room(b, obj_dir)

    def add(name, mat):
        verts, faces = _cornell_part(obj_dir, name)
        b.add_mesh(verts, faces, mat)

    if variant == "full":
        add("shortbox", white)
        add("tallbox", white)
        metal = b.add_metal((0.8, 0.85, 0.88), 0.0)
        b.add_sphere((400.0, 240.0, 190.0), 75.0, metal)
        glass = b.add_dielectric(1.5)
        b.add_sphere((160.0, 420.0, 360.0), 90.0, glass)
        # image-textured spheres (config 2 "textures"), wiring texture.h /
        # mTexID (SURVEY §2.1) end-to-end: a procedural checker plus a real
        # PNG *file* loaded from disk — the role the reference reserved
        # stb_image for (png_image.h:8-9) but never used.
        checker = np.zeros((8, 16, 3), np.float32)
        checker[::2, ::2] = checker[1::2, 1::2] = (0.9, 0.9, 0.85)
        checker[::2, 1::2] = checker[1::2, ::2] = (0.15, 0.25, 0.5)
        tid = b.add_texture(checker)
        tex_mat = b.add_lambertian((1.0, 1.0, 1.0), tex_id=tid)
        b.add_sphere((420.0, 90.0, 400.0), 90.0, tex_mat)
        if os.path.exists(MARBLE_PNG):
            from pathtracer_tpu.io.png import read_png
            marble = b.add_texture(read_png(MARBLE_PNG)[..., :3])
            marble_mat = b.add_lambertian((1.0, 1.0, 1.0), tex_id=marble)
            b.add_sphere((120.0, 75.0, 147.0), 75.0, marble_mat)
    else:
        s1 = b.add_lambertian((0.8, 0.3, 0.3))
        s2 = b.add_lambertian((0.3, 0.3, 0.8))
        b.add_sphere((185.0, 120.0, 169.0), 120.0, s1)
        b.add_sphere((368.0, 90.0, 351.0), 90.0, s2)

    # standard Cornell camera: at the open front face looking in (+z)
    cam = make_camera((278, 273, -800), (278, 273, 0), 40, aspect,
                      aperture=0, focus_dist=10, time0=0.0, time1=1.0)
    return b.build(), cam
