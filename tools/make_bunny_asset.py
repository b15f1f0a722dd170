"""Derive the vendored standalone bunny asset (assets/bunny.obj).

The flagship scene must be reproducible without the reference tree. The reference ships the public-domain Stanford
bunny (`models/bunny/bunny.obj`, 2,503 v / 4,968 f) but
never loads it (main.cu:534 is commented out). This tool produces a
*derived* asset — a quadric-style decimation of the Stanford scan — and
writes it in this repo's own OBJ conventions. Run once while the
reference tree is present; the output is committed under assets/.

Decimation = uniform-grid vertex clustering: vertices snap to their grid
cell's centroid, degenerate faces drop. Simple, watertightness-agnostic
(the Stanford scan has base holes), and the result is a genuinely
different mesh (fewer vertices, re-triangulated), not a copy.

Usage: python tools/make_bunny_asset.py [--grid 44] [--out assets/bunny.obj]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cluster_decimate(verts: np.ndarray, faces: np.ndarray, grid: int):
    """Grid-cluster decimation: (V,3) f64, (F,3) i64 -> smaller (V',F')."""
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    cell = np.minimum((verts - lo) / span * grid, grid - 1e-6).astype(
        np.int64)
    cid = (cell[:, 0] * grid + cell[:, 1]) * grid + cell[:, 2]
    uniq, inv = np.unique(cid, return_inverse=True)
    # new vertex = centroid of the cluster's members
    new_v = np.zeros((len(uniq), 3), np.float64)
    counts = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
    for k in range(3):
        new_v[:, k] = np.bincount(inv, weights=verts[:, k],
                                  minlength=len(uniq)) / counts
    nf = inv[faces]
    keep = ((nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2])
            & (nf[:, 0] != nf[:, 2]))
    nf = nf[keep]
    # drop duplicate faces (same vertex triple up to rotation)
    key = np.sort(nf, axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    nf = nf[np.sort(first)]
    return new_v, nf


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray,
              note: str) -> None:
    with open(path, "w") as f:
        f.write("# pathtracer_tpu vendored asset\n")
        f.write(f"# {note}\n")
        f.write(f"# {len(verts)} vertices, {len(faces)} faces\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in faces + 1:
            f.write(f"f {a} {b} {c}\n")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--src", required=True,
                   help="the reference's models/bunny/bunny.obj")
    p.add_argument("--grid", type=int, default=44)
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets", "bunny.obj"))
    args = p.parse_args()

    from pathtracer_tpu.io.obj import load_obj_python
    verts, faces = load_obj_python(args.src)
    nv, nf = cluster_decimate(np.asarray(verts, np.float64),
                              np.asarray(faces, np.int64), args.grid)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    write_obj(args.out, nv, nf,
              f"Stanford bunny (public domain scan), grid-{args.grid} "
              f"cluster decimation of the {len(verts)}v/{len(faces)}f scan")
    print(f"{args.src}: {len(verts)}v/{len(faces)}f -> "
          f"{args.out}: {len(nv)}v/{len(nf)}f")


if __name__ == "__main__":
    main()
