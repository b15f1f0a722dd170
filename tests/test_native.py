"""Native C++ runtime (libptnative.so): OBJ parser + PNG encoder must agree
with the pure-Python fallbacks (the host-side hot paths the reference keeps
in C/C++ — OBJ_Loader.hpp, stb_image_write; SURVEY §2.2)."""
import numpy as np
import pytest

from pathtracer_tpu.native import bindings

pytestmark = pytest.mark.skipif(not bindings.available(),
                                reason="native lib not built")

from pathtracer_tpu.scene.bunny import ASSET_OBJ as BUNNY  # noqa: E402


def test_native_obj_matches_python(tmp_path):
    from pathtracer_tpu.io.obj import load_obj_python
    text = """
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
f 1 2 3
f 2/1 4/2 3/3
f 1 2 4 3
"""
    p = tmp_path / "quad.obj"
    p.write_text(text)
    v_n, f_n = bindings.load_obj(str(p))
    v_p, f_p = load_obj_python(str(p))
    assert f_p.shape == (4, 3)  # quad fan-triangulated
    np.testing.assert_allclose(v_n, v_p)
    np.testing.assert_array_equal(f_n, f_p)


def test_native_obj_bunny():
    from pathtracer_tpu.io.obj import load_obj as py_load
    v_n, f_n = bindings.load_obj(BUNNY)
    v_p, f_p = py_load(BUNNY)
    assert v_n.shape == v_p.shape == (1817, 3)
    assert f_n.shape == f_p.shape == (3616, 3)
    np.testing.assert_allclose(v_n, v_p, atol=1e-6)
    np.testing.assert_array_equal(f_n, f_p)


def test_native_png_roundtrip(tmp_path):
    from PIL import Image
    rgba = np.zeros((7, 5, 4), np.uint8)
    rgba[..., 0] = np.arange(5)[None, :] * 40
    rgba[..., 1] = np.arange(7)[:, None] * 30
    rgba[..., 2] = 200
    rgba[..., 3] = 255
    p = str(tmp_path / "native.png")
    bindings.write_png(p, rgba)
    back = np.asarray(Image.open(p).convert("RGBA"))
    np.testing.assert_array_equal(back, rgba)
