"""Benchmark: forward path-tracing throughput of one scene on the GPU.

Prints the card's name and power limit, then ONE JSON line: nominal
Mrays/s (pixels x spp x max_depth closest-hit queries over wall-clock) and
executed Mrays/s (the queries that actually ran: the integrator's early
exit skips bounces once every ray has terminated), with compile time,
peak device memory and the device as JAX reports it.

A run without a GPU, or one that fails, prints a JSON line whose value is
null and whose ``error`` says "not measured", and exits nonzero. It never
prints a number from another run or another device.

Usage: python bench.py [--scene bunny] [--accel auto] [--width W]
                       [--height H] [--spp N] [--depth D] [--iters K]
                       [--subdivide L]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback


def _parse_args(argv=None):
    from pathtracer_tpu.config import ACCELS
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--scene", default="bunny")
    p.add_argument("--accel", default="auto", choices=ACCELS)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--ray-chunk", type=int, default=57600)
    p.add_argument("--subdivide", type=int, default=0,
                   help="bunny only: 4:1 midpoint subdivision levels "
                        "(4 -> ~0.93M triangles)")
    return p.parse_args(argv)


def metric_name(args) -> str:
    scene = (f"{args.scene}_sub{args.subdivide}"
             if args.subdivide and args.scene == "bunny" else args.scene)
    return f"{scene}_forward_throughput"


def bench_record(args, *, accel, prims, nominal, executed, shadow, dts,
                 compile_s, bvh_build_s, peak_bytes, device, gpu) -> dict:
    """The JSON line for one measured scene."""
    dt = sum(dts) / len(dts)
    return {
        "metric": metric_name(args),
        "value": nominal / dt / 1e6,
        "unit": "Mrays/s",
        "accel": accel,
        "prims": prims,
        "shape": [args.width, args.height, args.spp, args.depth],
        "nominal_queries": nominal,
        # closest-hit queries only (the population of nominal_queries);
        # NEE shadow queries are counted apart
        "executed_queries": executed,
        "shadow_queries": shadow,
        "executed_mrays_per_s": executed / dt / 1e6,
        "render_s": dts,
        "compile_s": compile_s,
        "bvh_build_s": bvh_build_s,
        "peak_bytes_in_use": peak_bytes,
        "device": device,
        "gpu": gpu,
    }


def run(args) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pathtracer_tpu import runtime
    from pathtracer_tpu.config import RenderConfig
    from pathtracer_tpu.render.renderer import (make_renderer, prepare_bvh,
                                                resolved_accel)
    from pathtracer_tpu.scene.worlds import get_world

    runtime.enable_compile_cache()
    runtime.require_gpu("bench.py")
    emissive = args.scene in ("cornell", "combined")
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.depth, accel=args.accel,
                       ray_chunk=args.ray_chunk, scene=args.scene,
                       # mirror the CLI: emissive-lit scenes use NEE, no sky
                       sky=not emissive, nee=emissive)
    scene_kw = ({"subdivide": args.subdivide}
                if args.subdivide and args.scene == "bunny" else {})
    scene, cam = get_world(args.scene, **scene_kw)
    t0 = time.perf_counter()
    bvh = jax.block_until_ready(prepare_bvh(cfg, scene))
    bvh_build_s = time.perf_counter() - t0 if bvh is not None else None

    render = make_renderer(cfg, with_bvh=bvh is not None, with_stats=True)
    t0 = time.perf_counter()
    compiled = render.lower(scene, bvh, cam, jnp.int32(0)).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(scene, bvh, cam, jnp.int32(0)))

    dts = []
    for i in range(args.iters):
        t0 = time.perf_counter()
        img, n_exec = compiled(scene, bvh, cam, jnp.int32(i + 1))
        n_exec = np.asarray(n_exec)
        jax.block_until_ready(img)
        dts.append(time.perf_counter() - t0)
    if not np.isfinite(np.asarray(img)).all():
        raise RuntimeError("non-finite pixels")
    stats = jax.devices()[0].memory_stats() or {}
    n_closest, n_shadow = (int(v) for v in n_exec)
    return bench_record(
        args, accel=resolved_accel(cfg), prims=int(scene.num_prims),
        nominal=cfg.num_pixels * cfg.spp * cfg.max_depth,
        executed=n_closest, shadow=n_shadow, dts=dts, compile_s=compile_s,
        bvh_build_s=bvh_build_s,
        peak_bytes=stats.get("peak_bytes_in_use"),
        device=runtime.device_info(), gpu=runtime.gpu_name_and_power())


def main(argv=None) -> int:
    args = _parse_args(argv)
    try:
        rec = run(args)
    except Exception as e:  # report, never fall back
        traceback.print_exc()
        print(json.dumps({"metric": metric_name(args), "value": None,
                          "unit": "Mrays/s",
                          "error": f"not measured: {type(e).__name__}: "
                                   f"{e}"[:2000]}))
        return 1
    print(rec["gpu"])
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
