"""ctypes bindings to the native C++ runtime library (libptnative.so).

The reference's host runtime is C++ (OBJ_Loader.hpp, stb_image_write, scene
upload drivers); this framework keeps a native runtime too for the
host-side hot paths: OBJ parsing and PNG encoding. Built by
``pathtracer_tpu/native/build.py`` (g++, no external deps); every entry point
has a pure-Python fallback so the framework works unbuilt.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_HERE = os.path.dirname(os.path.abspath(__file__))
LIB_PATH = os.path.join(_HERE, "libptnative.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(LIB_PATH):
        # try building once, quietly
        try:
            from pathtracer_tpu.native.build import build
            build(quiet=True)
        except Exception:
            return None
    if not os.path.exists(LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
        lib.pt_obj_counts.restype = ctypes.c_int
        lib.pt_obj_counts.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_long),
                                      ctypes.POINTER(ctypes.c_long)]
        lib.pt_obj_load.restype = ctypes.c_int
        lib.pt_obj_load.argtypes = [ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_long,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_long]
        lib.pt_write_png.restype = ctypes.c_int
        lib.pt_write_png.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_ubyte),
                                     ctypes.c_int, ctypes.c_int]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    lib = _load()
    assert lib is not None
    nv = ctypes.c_long()
    nf = ctypes.c_long()
    rc = lib.pt_obj_counts(path.encode(), ctypes.byref(nv), ctypes.byref(nf))
    if rc != 0:
        raise IOError(f"pt_obj_counts failed for {path}")
    verts = np.zeros((nv.value, 3), np.float32)
    faces = np.zeros((nf.value, 3), np.int32)
    rc = lib.pt_obj_load(
        path.encode(),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nv.value,
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), nf.value)
    if rc != 0:
        raise IOError(f"pt_obj_load failed for {path}")
    return verts, faces


def write_png(path: str, rgba: np.ndarray) -> None:
    lib = _load()
    assert lib is not None
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    rc = lib.pt_write_png(path.encode(),
                          rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                          w, h)
    if rc != 0:
        raise IOError(f"pt_write_png failed for {path}")
