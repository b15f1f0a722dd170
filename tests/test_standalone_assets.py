"""Built-in assets: the scenes need no files outside the repo.

- The Cornell box builds from the built-in canonical dataset.
- The bunny stand-in builds a renderable flagship scene end-to-end.
"""
import numpy as np


def test_cornell_scene_builds_without_objs():
    from pathtracer_tpu.scene.cornell import cornell_box
    scene, cam = cornell_box(obj_dir=None)
    assert scene.num_prims > 20
    assert scene.num_lights >= 1


def test_bunny_standin_renders():
    # an explicit missing path forces the last-resort stand-in (a missing
    # PT_BUNNY_OBJ env does not: resolve_bunny_obj falls through to the
    # vendored asset)
    from pathtracer_tpu.scene.bunny import bunny_world
    scene, cam = bunny_world(obj_path="/nonexistent/bunny.obj")
    assert scene.num_prims > 1000
    from pathtracer_tpu.config import RenderConfig
    from pathtracer_tpu.render.renderer import render_image
    cfg = RenderConfig(width=48, height=27, spp=1, max_depth=2,
                       ray_chunk=48 * 27, scene="bunny", accel="bvh")
    img = np.asarray(render_image(scene, cam, cfg))
    assert np.isfinite(img).all()
    assert img.mean() > 0.05  # lit scene, not black
