"""Large-mesh demo: render a tessellated bunny.

Subdivides the shipped bunny mesh 4:1 per level (same surface, 4^k x
triangles — level 2 is ~58k prims, level 4 ~0.93M) and renders it with
accel="auto" (on a GPU the Triton dense sweep, which beat the LBVH
traversal at every size measured — PERF.md) or ``--accel bvh``, the
reference's own structure for this scale (render_manager.h:86-135) as an
on-device LBVH build plus stackless traversal.

Usage:
    python examples/big_scene.py [--level 2] [--width 320] [--spp 4]
    # CPU check (use tiny sizes):
    python examples/big_scene.py --platform cpu --level 1 --width 96 --spp 1
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    from pathtracer_tpu.config import ACCELS

    p = argparse.ArgumentParser()
    p.add_argument("--level", type=int, default=2,
                   help="4:1 subdivision levels (2 -> 79.5k prims)")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--max-depth", type=int, default=4)
    p.add_argument("--out", default="big_bunny.png")
    p.add_argument("--accel", default="auto", choices=ACCELS)
    p.add_argument("--platform", default=None)
    args = p.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from pathtracer_tpu.config import RenderConfig
    from pathtracer_tpu.io.png import write_png
    from pathtracer_tpu.render.renderer import render_image
    from pathtracer_tpu.scene.bunny import bunny_world

    scene, cam = bunny_world(subdivide=args.level)
    n = int(scene.num_prims)
    print(f"level {args.level}: {n} primitives", flush=True)

    h = int(args.width * 9 / 16)
    cfg = RenderConfig(width=args.width, height=h, spp=args.spp,
                       max_depth=args.max_depth, accel=args.accel,
                       ray_chunk=min(57600, args.width * h),
                       scene="bunny")
    t0 = time.perf_counter()
    img = render_image(scene, cam, cfg, seed=0)
    img.block_until_ready()
    dt = time.perf_counter() - t0
    rays = cfg.num_pixels * cfg.spp * cfg.max_depth
    print(f"rendered {args.width}x{h}x{args.spp}spp in {dt:.1f} s "
          f"({rays / dt / 1e6:.2f} Mrays/s nominal, incl. compile)",
          flush=True)
    write_png(args.out, img)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
