"""Named BASELINE benchmark configurations (BASELINE.json "configs").

Each preset returns ``(scene, camera, RenderConfig)`` sized exactly as the
baseline describes; ``python -m pathtracer_tpu --preset <name>`` runs one.

| name             | BASELINE config                                         |
|------------------|---------------------------------------------------------|
| cornell-direct   | 1: Cornell diffuse spheres, 1 bounce, 16 spp, 256x256   |
| cornell-full     | 2: Cornell full materials + textures, 4 bounces, 64 spp |
| bunny            | 3: bunny OBJ + accel sweep, 4 bounces, 128 spp          |
| cornell-diff     | 4: differentiable pass fixture (scene only; see         |
|                  |    render/diff.fit for the inverse-rendering loop)      |
| combined-1080p   | 5: bunny + Cornell combined scene, 1080p, 512 spp —     |
|                  |    render over a mesh via parallel.sharded              |
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from pathtracer_tpu.config import RenderConfig
from pathtracer_tpu.core.camera import Camera, make_camera
from pathtracer_tpu.scene.scene import Scene, SceneBuilder


def combined_scene(aspect: float = 16.0 / 9.0) -> Tuple[Scene, Camera]:
    """Bunny + Cornell-box combined scene (BASELINE config 5).

    The Cornell room (reference OBJ assets, ~548-unit cube) with the bunny
    mesh standing inside it, plus the mirror/glass spheres — a single scene
    exercising every material family, mesh + analytic primitives, and the
    emissive light, sized for the tiled-1080p multi-chip benchmark.
    """
    from pathtracer_tpu.io.obj import load_obj
    from pathtracer_tpu.scene.bunny import resolve_bunny_obj
    from pathtracer_tpu.scene.cornell import CORNELL_DIR
    import os

    from pathtracer_tpu.scene.cornell import add_cornell_room
    b = SceneBuilder()
    add_cornell_room(b, CORNELL_DIR)

    # bunny, scaled to ~250 units, centered on the floor (PT_BUNNY_OBJ >
    # vendored assets/bunny.obj, like the flagship scene)
    obj_path = resolve_bunny_obj()
    if obj_path is not None:
        verts, faces = load_obj(obj_path)
    else:
        from pathtracer_tpu.scene.standalone_assets import bunny_standin
        verts, faces = bunny_standin()
    verts = verts.astype(np.float64)
    lo, hi = verts.min(0), verts.max(0)
    scale = 250.0 / float((hi - lo).max())
    verts = (verts - (lo + hi) / 2.0) * scale
    verts[:, 1] -= verts[:, 1].min()
    verts += np.array([278.0, 0.0, 280.0])
    grey = b.add_lambertian((0.65, 0.55, 0.45))
    b.add_mesh(verts.astype(np.float32), faces, grey)

    mirror = b.add_metal((0.8, 0.85, 0.88), 0.0)
    b.add_sphere((120.0, 90.0, 150.0), 90.0, mirror)
    glass = b.add_dielectric(1.5)
    b.add_sphere((430.0, 90.0, 150.0), 90.0, glass)

    cam = make_camera((278, 273, -800), (278, 273, 0), 40, aspect,
                      aperture=0, focus_dist=10, time0=0.0, time1=1.0)
    return b.build(), cam


def scale_config(cfg: RenderConfig, scale: float) -> RenderConfig:
    """Scale a preset's resolution and spp (``--scale``; 0.25 gives the
    quick proxy runs). Depth and everything else stay as they are."""
    if scale == 1.0:
        return cfg
    return cfg.replace(width=max(8, int(cfg.width * scale)),
                       height=max(8, int(cfg.height * scale)),
                       spp=max(1, int(cfg.spp * scale)))


def get_preset(name: str):
    """(scene, camera, RenderConfig) for a named BASELINE config."""
    from pathtracer_tpu.scene.cornell import cornell_box
    from pathtracer_tpu.scene.worlds import get_world

    if name == "cornell-direct":
        scene, cam = cornell_box(variant="spheres")
        return scene, cam, RenderConfig(
            width=256, height=256, spp=16, max_depth=2, sky=False,
            nee=True, stratify=True, accel="auto", scene="cornell")
    if name == "cornell-full":
        scene, cam = cornell_box(variant="full")
        return scene, cam, RenderConfig(
            width=256, height=256, spp=64, max_depth=4, sky=False,
            nee=True, stratify=True, accel="auto", scene="cornell")
    if name == "cornell-diff":
        scene, cam = cornell_box(variant="spheres")
        return scene, cam, RenderConfig(
            width=64, height=64, spp=8, max_depth=2, sky=False,
            nee=True, accel="brute", scene="cornell")
    if name == "bunny":
        scene, cam = get_world("bunny")
        return scene, cam, RenderConfig(
            width=800, height=450, spp=128, max_depth=4,
            stratify=True, accel="auto", scene="bunny")
    if name == "combined-1080p":
        scene, cam = combined_scene()
        return scene, cam, RenderConfig(
            width=1920, height=1080, spp=512, max_depth=4, sky=False,
            nee=True, stratify=True, accel="auto", ray_chunk=129600,
            scene="combined")
    raise ValueError(
        f"unknown preset {name!r}; available: cornell-direct / cornell-full "
        f"/ cornell-diff / bunny / combined-1080p")
