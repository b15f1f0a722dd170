"""Reconstruct the historical random world behind ``output2/2.lbvh.png``.

The tree's ``generateRandomWorldOnHost`` (``main.cu:209-211``) places the
small spheres on an exact integer grid, but the shipped renders
(``output2/2.lbvh.png``, ``output/13.png``) show RTIOW-classic *jittered*
positions — the PNGs predate the tree. Because every draw comes from the
same default-seeded ``std::mt19937`` (``utility.h:103-108``), each
plausible historical draw order is a fully deterministic scene; this tool
renders each hypothesis at low resolution against the shipped PNG and
reports RMSE — a position-matching hypothesis snaps the error down, a
mismatch stays at field-decorrelation level (~0.19).

Hypotheses (per grid cell, all from one shared mt19937 stream):
  grid      — the tree's code as-is (control: positions on the grid)
  classic   — RTIOW book order: choose, jx, jz; cull |c-(4,.2,0)|<=0.9;
              diffuse 6 draws, metal 3+1 (albedo scaled to [.5,1), fuzz
              [0,.5)), glass 0   [tested with sampleNum 10 and 11]
  eager     — tree's unconditional 6 material draws + jitter: choose, jx,
              jz, rand1 x3, rand2 x3, no cull
  eager_cull— eager + the classic cull
  jitter_after — choose, rand1 x3, rand2 x3, then jx, jz (jitter drawn
              after materials), no cull

Run (CPU, ~5-10 min): python tools/fit_reference_world.py

RESULT (2026-08-18, 120x67 @ 4 spp, 7 (layout, sampleNum) configs x 2
cameras): every hypothesis lands at RMSE 0.20-0.21 with no
position-matching snap (a matching field would drop the error by several
x). The historical generator was structurally different from all the
reconstructions (or differently seeded — the render-time
pixel seed WAS time-based, main.cu:420-422). Conclusion recorded in
BASELINE.md: the shipped PNG's random field is not reproducible from the
shipped source; forward parity is therefore quantified on the
deterministic elements (hero spheres, ground, sky, composition) plus a
global noise-scaled RMSE with the fitted camera — tools/parity.py.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_PNG = "output2/2.lbvh.png"  # under the reference renderer's tree


def build_world(layout: str, sample_num: int, pad_to: int):
    from pathtracer_tpu.scene.reference_world import MT19937, _mt19937_f32
    from pathtracer_tpu.scene.scene import SceneBuilder

    gen = MT19937()
    rnd = lambda: float(_mt19937_f32(gen))  # noqa: E731

    b = SceneBuilder()
    ground = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0, -1000, 0), 1000.0, ground)

    for i in range(-sample_num, sample_num):
        for j in range(-sample_num, sample_num):
            choose = rnd()
            if layout == "grid":
                center = (float(i), 0.2, float(j))
            elif layout in ("classic", "eager", "eager_cull"):
                center = (i + 0.9 * rnd(), 0.2, j + 0.9 * rnd())
            elif layout == "jitter_after":
                center = None  # drawn after materials
            else:
                raise ValueError(layout)

            if layout in ("grid", "eager", "eager_cull", "jitter_after"):
                rand1 = np.array([rnd(), rnd(), rnd()], np.float32)
                rand2 = np.array([rnd(), rnd(), rnd()], np.float32)
                if layout == "jitter_after":
                    center = (i + 0.9 * rnd(), 0.2, j + 0.9 * rnd())
                if layout == "eager_cull":
                    c = np.array(center) - np.array([4.0, 0.2, 0.0])
                    if float(np.sqrt((c * c).sum())) <= 0.9:
                        continue
                if choose < 0.8:
                    mat = b.add_lambertian(rand1 * rand2)
                elif choose < 0.95:
                    mat = b.add_metal(rand1 / 2 + 0.5, float(rand2[0] / 2))
                else:
                    mat = b.add_dielectric(1.5)
                b.add_sphere(center, 0.2, mat)
            else:  # classic: conditional draw counts, cull before materials
                c = np.array(center) - np.array([4.0, 0.2, 0.0])
                if float(np.sqrt((c * c).sum())) <= 0.9:
                    continue
                if choose < 0.8:
                    a1 = np.array([rnd(), rnd(), rnd()], np.float32)
                    a2 = np.array([rnd(), rnd(), rnd()], np.float32)
                    mat = b.add_lambertian(a1 * a2)
                elif choose < 0.95:
                    alb = np.array([rnd(), rnd(), rnd()], np.float32)
                    fuzz = rnd()
                    mat = b.add_metal(alb / 2 + 0.5, fuzz / 2)
                else:
                    mat = b.add_dielectric(1.5)
                b.add_sphere(center, 0.2, mat)

    glass = b.add_dielectric(1.5)
    b.add_sphere((4, 1, 0), 1.0, glass)
    b.add_sphere((4, 1, 0), -0.9, glass)
    pink = b.add_lambertian((1.0, 0.0, 0.4))
    b.add_sphere((-4, 1, 0), 1.0, pink)
    mirror = b.add_metal((0.7, 0.6, 0.5), 0.0)
    b.add_sphere((0, 1, 0), 1.0, mirror)
    return b.build(pad_to=pad_to)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=120)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--reference", default=".",
                   help="the reference renderer's source tree")
    p.add_argument("--out", default="fit_world_out")
    args = p.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")

    from pathtracer_tpu.config import K_ASPECT_RATIO, RenderConfig
    from pathtracer_tpu.core.camera import make_camera
    from pathtracer_tpu.io.png import read_png, write_png
    from pathtracer_tpu.render.renderer import render_image
    from tools.parity import resize_bilinear

    os.makedirs(args.out, exist_ok=True)
    target = read_png(os.path.join(args.reference, REF_PNG))[
        ..., :3].astype(np.float32)
    w = args.width
    h = int(w / K_ASPECT_RATIO * 0.99999 + 0.5)
    tgt = resize_bilinear(target, h, w)
    cfg = RenderConfig(width=w, height=h, spp=args.spp, max_depth=8,
                       accel="tensor", ray_chunk=w * h, scene="random")

    # one pad size for every hypothesis -> one XLA compile
    PAD = 520
    cam_classic = make_camera((13, 2, 3), (0, 0, 0), 20, K_ASPECT_RATIO,
                              aperture=0.1, focus_dist=10, time0=0, time1=1)
    cam_gridfit = make_camera((14, 2.25, 4), (0, 0, 0), 20, K_ASPECT_RATIO,
                              aperture=0.1, focus_dist=10, time0=0, time1=1)

    results = {}
    for name, layout, sn in (
            ("grid_sn10", "grid", 10),
            ("classic_sn11", "classic", 11),
            ("classic_sn10", "classic", 10),
            ("eager_sn10", "eager", 10),
            ("eager_cull_sn10", "eager_cull", 10),
            ("eager_sn11", "eager", 11),
            ("jitter_after_sn10", "jitter_after", 10)):
        scene = build_world(layout, sn, PAD)
        for cam_name, cam in (("classic", cam_classic),
                              ("gridfit", cam_gridfit)):
            img = np.asarray(render_image(scene, cam, cfg))[::-1]
            rmse = float(np.sqrt(np.mean((img - tgt) ** 2)))
            results[f"{name}/{cam_name}"] = round(rmse, 4)
            write_png(os.path.join(args.out, f"{name}_{cam_name}.png"),
                      img[::-1])
            print(f"{name:22s} cam={cam_name:8s} rmse={rmse:.4f}",
                  flush=True)

    best = min(results, key=results.get)
    print(json.dumps({"best": best, "rmse": results[best],
                      "all": results}, indent=2))


if __name__ == "__main__":
    main()
