"""Scaling benchmark: the sharded render over 1, 2, 4, ... local GPUs.

For each mesh size the sharded renderer (parallel/sharded.py, pixels on
the ``rays`` axis) renders the same frame; prints the card's name and power
limit, then one JSON line per mesh size with nominal Mrays/s and the
efficiency against the one-device rate. Timing forces the image to the
host, so it covers the whole frame including the framebuffer all_gather.

Usage:
    python bench_scaling.py [--devices 1 2 4] [--scene bunny] [--accel auto]
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main() -> int:
    from pathtracer_tpu.config import ACCELS
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, nargs="*", default=None,
                   help="mesh sizes to test (default: 1, 2, 4, ... up to "
                        "all local devices)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--scene", default="bunny")
    p.add_argument("--accel", default="auto", choices=ACCELS)
    p.add_argument("--iters", type=int, default=3)
    args = p.parse_args()

    import jax
    import numpy as np

    from pathtracer_tpu import runtime
    from pathtracer_tpu.config import RenderConfig
    from pathtracer_tpu.parallel import make_mesh, make_sharded_renderer
    from pathtracer_tpu.render.renderer import prepare_bvh, resolved_accel
    from pathtracer_tpu.scene.worlds import get_world

    runtime.enable_compile_cache()
    runtime.require_gpu("bench_scaling.py")
    n_avail = len(jax.devices())
    sizes = args.devices
    if not sizes:
        sizes, n = [], 1
        while n <= n_avail:
            sizes.append(n)
            n *= 2

    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.depth, accel=args.accel,
                       scene=args.scene)
    scene, cam = get_world(args.scene)
    bvh = prepare_bvh(cfg, scene)
    queries = cfg.num_pixels * cfg.spp * cfg.max_depth
    print(runtime.gpu_name_and_power())

    results = {}
    for n in sizes:
        if n > n_avail:
            raise SystemExit(f"need {n} devices, have {n_avail}")
        mesh = make_mesh(jax.devices()[:n], spp_axis_size=1)
        render = make_sharded_renderer(cfg, mesh, with_bvh=bvh is not None)
        np.asarray(render(scene, bvh, cam, 0))  # compile + settle
        dts = []
        for i in range(args.iters):
            t0 = time.perf_counter()
            np.asarray(render(scene, bvh, cam, i + 1))
            dts.append(time.perf_counter() - t0)
        mrays = queries / (sum(dts) / len(dts)) / 1e6
        results[n] = mrays
        eff = mrays / (results[1] * n) if 1 in results else None
        print(json.dumps({"metric": "scaling", "devices": n,
                          "scene": args.scene,
                          "accel": resolved_accel(cfg),
                          "value": mrays, "unit": "Mrays/s",
                          "render_s": dts, "efficiency": eff,
                          "device": runtime.device_info()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
