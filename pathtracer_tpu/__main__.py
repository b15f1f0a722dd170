"""CLI driver: render a scene to PNG.

Replaces the reference's argv-less ``main()`` -> ``renderToPng``
(``main.cu:530-535``, ``main.cu:462-487``) with a real command line over the
runtime config. Prints the same "Time Cost" wall-clock line plus Mrays/s.

Usage:
    python -m pathtracer_tpu [--scene triangle] [--width 800] [--spp 100] ...
"""
from __future__ import annotations

import argparse
import sys
import time

from pathtracer_tpu.config import ACCELS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtracer_tpu",
        description="Differentiable Monte Carlo path tracer (JAX)")
    p.add_argument("--scene", default="triangle",
                   help="test | triangle | random | cornell | bunny")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=450)
    p.add_argument("--spp", type=int, default=100)
    p.add_argument("--max-depth", type=int, default=50)
    p.add_argument("--accel", default=None, choices=ACCELS,
                   help="acceleration structure (default auto: dense sweep"
                        " below ~1k prims, LBVH traversal above; with "
                        "--preset, overrides the preset's accel)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ray-chunk", type=int, default=None,
                   help="wavefront chunk size (default 16384; with "
                        "--preset, overrides the preset's chunk)")
    p.add_argument("--no-sky", action="store_true",
                   help="black background (emissive-lit scenes)")
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation (sample area lights at "
                        "diffuse bounces; for emissive-lit scenes)")
    p.add_argument("--sampler", default="random",
                   choices=["random", "sobol"],
                   help="pixel-filter sampler: uniform jitter (reference "
                        "behavior) or per-pixel Owen-scrambled Sobol "
                        "(lower variance at equal spp)")
    p.add_argument("--rr", action="store_true",
                   help="Russian-roulette termination after --rr-depth "
                        "bounces (reference constants 0.8/1.25)")
    p.add_argument("--rr-depth", type=int, default=3)
    p.add_argument("--terminate-black", action="store_true",
                   help="depth-exhausted rays return black instead of the "
                        "reference's sky*attenuation quirk")
    p.add_argument("-o", "--output", default="debug.png",
                   help="output PNG path (reference writes "
                        "../output2/debug.png)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file: accumulate spp in resumable "
                        "chunks; re-running resumes where it stopped")
    p.add_argument("--spp-per-pass", type=int, default=8,
                   help="samples per device execution (bounds program "
                        "runtime and gives progress lines)")
    p.add_argument("--interactive", action="store_true",
                   help="progressive terminal viewer with WASD/QE camera")
    p.add_argument("--platform", default=None,
                   help="JAX platform to run on; without it a GPU is "
                        "required (use 'cpu' for small CPU renders)")
    p.add_argument("--mesh", default=None,
                   help="render sharded over a device mesh: '8' (rays only) "
                        "or '4x2' (rays x spp axes); config-5 path")
    p.add_argument("--host-devices", type=int, default=None,
                   help="with --platform cpu: number of virtual host "
                        "devices (for testing --mesh without a pod)")
    p.add_argument("--preset", default=None,
                   help="named BASELINE config (cornell-direct / "
                        "cornell-full / cornell-diff / bunny / "
                        "combined-1080p); overrides scene/size/spp/depth")
    p.add_argument("--scale", type=float, default=1.0,
                   help="resolution/spp scale factor applied to --preset "
                        "(e.g. 0.25 for a quick proxy run)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.host_devices:
        import os
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.host_devices}")
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from pathtracer_tpu import runtime
    if args.platform is None and jax.default_backend() != "gpu":
        print(f"error: no GPU found (JAX platform "
              f"{jax.default_backend()!r}); pass --platform cpu to render "
              "on the CPU", file=sys.stderr)
        return 2
    runtime.enable_compile_cache()

    # Defer heavy imports so --help is instant.
    import numpy as np
    from pathtracer_tpu.config import RenderConfig
    from pathtracer_tpu.io.png import write_png
    from pathtracer_tpu.render.renderer import render_image
    from pathtracer_tpu.scene.worlds import get_world

    try:
        if args.preset:
            from pathtracer_tpu.presets import get_preset, scale_config
            scene, cam, cfg = get_preset(args.preset)
            cfg = scale_config(cfg, args.scale).replace(seed=args.seed)
            if args.accel:
                cfg = cfg.replace(accel=args.accel)
            if args.ray_chunk:
                cfg = cfg.replace(ray_chunk=args.ray_chunk)
            if args.rr:
                cfg = cfg.replace(rr=True, rr_depth=args.rr_depth)
            if args.sampler != "random":
                cfg = cfg.replace(sampler=args.sampler)
        else:
            scene, cam = get_world(args.scene)
            sky = not args.no_sky
            if args.scene == "cornell":
                sky = False  # lit by the area light
            cfg = RenderConfig(width=args.width, height=args.height,
                               spp=args.spp, max_depth=args.max_depth,
                               accel=args.accel or "auto", seed=args.seed,
                               ray_chunk=args.ray_chunk or 16384, sky=sky,
                               nee=args.nee or args.scene == "cornell",
                               terminate_black=args.terminate_black,
                               rr=args.rr, rr_depth=args.rr_depth,
                               sampler=args.sampler, scene=args.scene)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.interactive:
        from pathtracer_tpu.viewer.interactive import run_viewer
        return run_viewer(scene, cam, cfg)

    print(f"Rendering {cfg.scene}: {cfg.width}x{cfg.height}, "
          f"{cfg.spp} spp, depth {cfg.max_depth}, accel={cfg.accel}"
          + (", nee" if cfg.nee else ""))
    print("Start rendering!")
    start = time.perf_counter()
    if args.mesh:
        # sharded whole-image render (parallel/sharded.py); one device
        # program — prefer proxy scales for very large spp
        import jax
        from pathtracer_tpu.parallel import make_mesh, sharded_render_image
        parts = args.mesh.lower().split("x")
        rays_n = int(parts[0])
        spp_n = int(parts[1]) if len(parts) > 1 else 1
        mesh = make_mesh(jax.devices()[:rays_n * spp_n],
                         spp_axis_size=spp_n)
        print(f"mesh: {dict(mesh.shape)}")
        img = np.asarray(sharded_render_image(scene, cam, cfg, mesh))
    elif args.checkpoint or cfg.spp > args.spp_per_pass:
        # bounded executions (+ optional resume): utils/checkpoint.py
        from pathtracer_tpu.utils.checkpoint import render_with_checkpoints

        def show(done, total):
            print(f"  {done}/{total} spp "
                  f"({time.perf_counter() - start:.1f}s)", flush=True)

        img = render_with_checkpoints(scene, cam, cfg, args.checkpoint,
                                      spp_per_chunk=args.spp_per_pass,
                                      progress=show)
    else:
        img = np.asarray(render_image(scene, cam, cfg))
    duration = time.perf_counter() - start
    # "Time Cost" print, matching main.cu:476; plus a throughput line.
    print(f"Time Cost: {duration:.6g}")
    rays = cfg.num_pixels * cfg.spp
    print(f"Camera rays: {rays} ({rays / duration / 1e6:.2f} Mrays/s "
          f"lower bound, excl. bounces)")
    write_png(args.output, img)
    print(f"Wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
