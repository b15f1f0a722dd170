"""PNG writer/reader + OBJ loader tests."""
import os

import numpy as np

from pathtracer_tpu.io import obj as obj_mod
from pathtracer_tpu.io import png as png_mod


def test_png_roundtrip(tmp_path):
    img = np.random.default_rng(0).random((13, 17, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    png_mod.write_png(path, img, flip_rows=False)
    back = png_mod.read_png(path)
    assert back.shape == (13, 17, 4)
    # quantization: clamp(c, 0, .999) * 256 truncated (png_image.h:26-29)
    expect = (np.clip(img, 0, 0.999) * 256).astype(np.uint8)
    np.testing.assert_array_equal((back[..., :3] * 255).round().astype(np.uint8),
                                  expect)
    assert (back[..., 3] == 1.0).all()


def test_png_row_flip(tmp_path):
    img = np.zeros((2, 2, 3), np.float32)
    img[0] = 1.0  # bottom row white
    path = str(tmp_path / "f.png")
    png_mod.write_png(path, img, flip_rows=True)
    back = png_mod.read_png(path)
    assert back[1, 0, 0] > 0.9  # white ended up at the bottom of the file
    assert back[0, 0, 0] < 0.1


def test_obj_parser(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("""
# comment
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
vt 0 0
f 1/1/1 2/1/1 3/1/1 4/1/1
f -4 -3 -2
""")
    verts, faces = obj_mod.load_obj_python(str(p))
    assert verts.shape == (4, 3)
    # quad fan-triangulated into 2 + the negative-index triangle
    assert faces.shape == (3, 3)
    np.testing.assert_array_equal(faces[0], [0, 1, 2])
    np.testing.assert_array_equal(faces[1], [0, 2, 3])
    np.testing.assert_array_equal(faces[2], [0, 1, 2])


def test_obj_reference_assets():
    """The vendored bunny asset parses (the reference never loads its
    bunny — SURVEY §2.1 mesh-loader row — we do)."""
    from pathtracer_tpu.scene.bunny import ASSET_OBJ
    verts, faces = obj_mod.load_obj_python(ASSET_OBJ)
    assert verts.shape == (1817, 3)
    assert faces.shape == (3616, 3)
