"""Quantified forward-parity vs the reference's shipped renders.

Targets (``--target``):

- ``lbvh`` -> ``output2/2.lbvh.png`` (1200x675), the tree-era baseline
  (SURVEY §4). The *tree's* scene is bit-reproducible — material draws come
  from a default-seeded std::mt19937 (scene/reference_world.py) and the tree
  places all small spheres on an exact integer grid (``main.cu:209-211``) —
  but the PNG predates the tree: its camera differs (``initWorldStates`` now
  pairs the random world with a top-down camera, main.cu:412-416) AND its
  small-sphere field is jittered. A 7-configuration mt19937 draw-order sweep
  (tools/fit_reference_world.py) found no reconstruction of the historical
  field (all RMSE ~0.20), so the field decorrelation is an unremovable floor
  on the global score; parity is carried by the deterministic elements
  (hero-sphere crops, ground, sky, composition).
- ``rtiow`` -> ``output/13_2.png`` (1200x800, the RTIOW 3:2 book frame),
  the development-era final-scene milestone. Its hero layout (glass right,
  cream metal center, pink matte left, from (13,2,3)) is exactly the tree's
  generator order (glass at (4,1,0), metal at (0,1,0), color(1,0,0.4) at
  (-4,1,0); main.cu:233-243), so this target exercises the *same* hero
  composition the tree produces — the best available anchor for the
  deterministic elements. ``13.png``/``13_1.png`` are earlier passes of the
  same frame (no/partial defocus) and can be given by path.

The harness:

1. rebuilds the exact scene,
2. fits the historical camera by coarse-to-fine grid search around a
   per-target seed (the RTIOW classic (13,2,3) -> origin view),
3. renders at the target's own aspect and reports noise-aware parity scores:
   global RMSE/PSNR + SSIM on box-downsampled images, and per-hero-sphere
   crop mean-color error + crop SSIM.

Results are recorded in BASELINE.md. Run (CPU ok, ~10-20 min):
    python tools/parity.py --reference DIR [--target lbvh|rtiow|PATH]
        [--out parity_out]
                           [--quick]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TARGETS = {
    # alias: (path under the reference tree, camera seed, hero crop boxes
    # as (x0f, x1f, y0f, y1f))
    "lbvh": (
        "output2/2.lbvh.png",
        dict(lookfrom=(14.0, 2.25, 4.0), lookat=(0.0, 0.0, 0.0),
             vfov=20.0, aperture=0.1),
        {
            "pink":   (0.28, 0.45, 0.05, 0.35),
            "mirror": (0.40, 0.55, 0.10, 0.42),
            "glass":  (0.55, 0.78, 0.10, 0.60),
        },
    ),
    "rtiow": (
        "output/13_2.png",
        # fitted camera (tools/fit_reference_world.py) — the search seeded
        # at the RTIOW book view (13,2,3) and converged here, the same fit the
        # lbvh target found; --quick reproduces the recorded scores
        dict(lookfrom=(14.0, 2.25, 4.0), lookat=(0.0, 0.0, 0.0),
             vfov=20.0, aperture=0.1),
        {
            # fractions measured off 13_2.png (1200x800, row 0 = top)
            "pink":   (0.28, 0.44, 0.05, 0.38),
            "mirror": (0.37, 0.55, 0.06, 0.50),
            "glass":  (0.50, 0.85, 0.05, 0.70),
        },
    ),
}


def ssim(a, b):
    """Mean SSIM on luminance, 11x11 Gaussian window (sigma 1.5), the
    standard Wang et al. constants — numpy only."""
    def lum(x):
        return (0.2126 * x[..., 0] + 0.7152 * x[..., 1]
                + 0.0722 * x[..., 2]).astype(np.float64)

    x, y = lum(a), lum(b)
    r = np.arange(11) - 5
    g = np.exp(-(r ** 2) / (2 * 1.5 ** 2))
    g /= g.sum()

    def filt(z):
        z = np.apply_along_axis(lambda m: np.convolve(m, g, "valid"), 0, z)
        return np.apply_along_axis(lambda m: np.convolve(m, g, "valid"), 1, z)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mx, my = filt(x), filt(y)
    vx = filt(x * x) - mx * mx
    vy = filt(y * y) - my * my
    cxy = filt(x * y) - mx * my
    s = ((2 * mx * my + c1) * (2 * cxy + c2)
         / ((mx * mx + my * my + c1) * (vx + vy + c2)))
    return float(s.mean())


def resize_bilinear(img, h, w):
    """Minimal bilinear resize (no scipy/PIL dependency)."""
    H, W = img.shape[:2]
    y = (np.arange(h) + 0.5) * H / h - 0.5
    x = (np.arange(w) + 0.5) * W / w - 0.5
    y0 = np.clip(np.floor(y).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(x).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    fy = np.clip(y - y0, 0, 1)[:, None, None]
    fx = np.clip(x - x0, 0, 1)[None, :, None]
    a = img[y0][:, x0] * (1 - fy) * (1 - fx)
    b = img[y0][:, x1] * (1 - fy) * fx
    c = img[y1][:, x0] * fy * (1 - fx)
    d = img[y1][:, x1] * fy * fx
    return a + b + c + d


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--target", default="lbvh",
                   help="alias (%s) or a PNG path" % "/".join(TARGETS))
    p.add_argument("--reference", default=".",
                   help="the reference renderer's source tree (the "
                        "target aliases are PNGs under it)")
    p.add_argument("--out", default="parity_out")
    p.add_argument("--quick", action="store_true",
                   help="skip the camera search, use the stored best fit")
    p.add_argument("--final-width", type=int, default=400)
    p.add_argument("--final-spp", type=int, default=48)
    args = p.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")

    from pathtracer_tpu.config import RenderConfig
    from pathtracer_tpu.core.camera import make_camera
    from pathtracer_tpu.io.png import read_png, write_png
    from pathtracer_tpu.render.renderer import render_image
    from pathtracer_tpu.scene.reference_world import reference_random_world

    if args.target in TARGETS:
        ref_png, seed_cam, boxes = TARGETS[args.target]
        ref_png = os.path.join(args.reference, ref_png)
        target = read_png(ref_png)[..., :3].astype(np.float32)
    else:
        # path form: adopt the seed camera + hero-crop boxes of the alias
        # whose frame aspect matches (13.png/13_1.png are 3:2 RTIOW
        # frames -> rtiow composition; 16:9-ish -> lbvh)
        ref_png = args.target
        target = read_png(ref_png)[..., :3].astype(np.float32)
        asp = target.shape[1] / target.shape[0]
        alias = min(TARGETS.values(),
                    key=lambda t: abs(
                        asp - (lambda im: im.shape[1] / im.shape[0])(
                            read_png(os.path.join(args.reference,
                                                  t[0])))))
        _, seed_cam, boxes = alias

    os.makedirs(args.out, exist_ok=True)
    aspect = target.shape[1] / target.shape[0]

    scene, _ = reference_random_world()

    sw = 160
    sh = int(round(sw / aspect))
    scfg = RenderConfig(width=sw, height=sh, spp=4, max_depth=8,
                        accel="tensor", ray_chunk=sw * sh, scene="random")
    tgt_s = resize_bilinear(target, sh, sw)

    def render_with(cfg, lookfrom, lookat, vfov, aperture):
        cam = make_camera(lookfrom, lookat, vfov, aspect,
                          aperture=aperture, focus_dist=10,
                          time0=0, time1=1)
        img = np.asarray(render_image(scene, cam, cfg))
        return img[::-1]  # renderer row 0 = bottom; PNG row 0 = top

    def score(img, tgt):
        return float(np.sqrt(np.mean((img - tgt) ** 2)))

    # stored best fit per target (recorded in BASELINE.md); --quick uses it
    # as-is, otherwise the coarse-to-fine search refines from here
    best = dict(seed_cam)
    if not args.quick:
        def search(param_grid):
            nonlocal best
            b = score(render_with(scfg, **best), tgt_s)
            for cand in param_grid:
                c = dict(best, **cand)
                s = score(render_with(scfg, **c), tgt_s)
                if s < b:
                    b, best = s, c
            print(f"  best {b:.4f} <- {best}", flush=True)

        print("stage 1: position", flush=True)
        search([dict(lookfrom=(x, y, z))
                for x in (11.0, 13.0, 15.0)
                for y in (1.5, 2.0, 2.5)
                for z in (2.0, 3.0, 4.0)])
        print("stage 2: vfov/aim/aperture", flush=True)
        search([dict(vfov=v, lookat=(0.0, la, 0.0), aperture=a)
                for v in (18.0, 20.0, 22.0, 25.0)
                for la in (0.0, 0.5, 1.0)
                for a in (0.0, 0.1)])
        x0, y0, z0 = best["lookfrom"]
        print("stage 3: fine position", flush=True)
        search([dict(lookfrom=(x0 + dx, y0 + dy, z0 + dz))
                for dx in (-1.0, 0.0, 1.0)
                for dy in (-0.25, 0.0, 0.25)
                for dz in (-0.5, 0.0, 0.5)])

    fw = args.final_width
    fh = int(round(fw / aspect))
    fcfg = RenderConfig(width=fw, height=fh, spp=args.final_spp, max_depth=16,
                        accel="tensor", ray_chunk=fw * fh, scene="random")
    img = render_with(fcfg, **best)
    tgt_f = resize_bilinear(target, fh, fw)
    write_png(os.path.join(args.out, "ours.png"), img[::-1])
    write_png(os.path.join(args.out, "target.png"), tgt_f[::-1])

    rmse = score(img, tgt_f)
    psnr = 20 * np.log10(1.0 / max(rmse, 1e-9))
    ssim_global = ssim(img, tgt_f)

    # hero-sphere crops: projecting the known centers with the fitted camera
    # is overkill — sample fixed fractional boxes (per target, see TARGETS)
    # that cover each hero in both images (verified visually; the composition
    # is locked by the fit).
    crops = {}
    for name, (x0f, x1f, y0f, y1f) in boxes.items():
        sl = (slice(int(y0f * fh), int(y1f * fh)),
              slice(int(x0f * fw), int(x1f * fw)))
        crops[name] = dict(
            ours=[round(float(v), 4) for v in img[sl].mean((0, 1))],
            ref=[round(float(v), 4) for v in tgt_f[sl].mean((0, 1))],
            mean_abs_err=round(float(np.abs(img[sl] - tgt_f[sl]).mean()), 4),
            ssim=round(ssim(img[sl], tgt_f[sl]), 4))

    result = dict(target=ref_png, camera=best, rmse=round(rmse, 4),
                  psnr_db=round(float(psnr), 2),
                  ssim=round(ssim_global, 4), crops=crops)
    print(json.dumps(result, indent=2))
    with open(os.path.join(args.out, "parity.json"), "w") as f:
        json.dump(result, f, indent=2)


if __name__ == "__main__":
    main()
