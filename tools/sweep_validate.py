"""Per-scene closest-hit fidelity of each accel against a float64 oracle.

For each scene: half camera rays, half synthetic bounce rays (origins in
the scene's bounds, random directions — away from the camera's
well-conditioned region). Every accel's winners and t are compared with the
factored reference tests evaluated at float64 (oracle.closest_hit):

- winner-flip rate: rays whose hit/miss verdict or winning primitive
  differs from the exact answer. The bar is 5e-5 of rays, or the f32 brute
  scan's own rate where that is higher (on the random world f32 itself
  flips ~1.5e-4 against float64) — razor-edge ties flip under any f32
  association order; systematic precision loss (e.g. low-precision sweep
  splits on large-extent spheres) flips orders of magnitude more.
- relative t error (p99, max) on agreeing winners, beside the f32 brute
  scan's own.

Run on the GPU (compiled kernels) or with --platform cpu (the Triton kernel
in interpret mode; use fewer rays):

    python tools/sweep_validate.py [--scenes test,triangle,random,bunny]
        [--accels brute,tensor,pallas,bvh] [--precisions fused6,highest]

Emits one JSON line per (scene, accel) and a PASS/FAIL verdict.
"""
import argparse
import functools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FLIP_BAR = 5e-5


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scenes", default="test,triangle,random,bunny")
    p.add_argument("--accels", default="brute,tensor,pallas,bvh")
    p.add_argument("--precisions", default="fused6",
                   help="PT_SWEEP_PRECISION modes for the tensor accel")
    p.add_argument("--rays", type=int, default=20000)
    p.add_argument("--platform", default=None)
    args = p.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    import numpy as np

    from pathtracer_tpu import oracle
    from pathtracer_tpu.accel.lbvh import build_lbvh
    from pathtracer_tpu.ops import intersect, pallas_sweep
    from pathtracer_tpu.ops.tensor_sweep import make_tensor_closest_hit
    from pathtracer_tpu.ops.traversal import make_bvh_closest_hit
    from pathtracer_tpu.scene import worlds

    interpret = jax.default_backend() != "gpu"
    t_min = 1e-3
    ok = True
    for scene_name in args.scenes.split(","):
        scene, cam = worlds.get_world(scene_name)
        rng = np.random.default_rng(11)
        n = args.rays
        u = rng.random(n // 2, dtype=np.float32)
        v = rng.random(n // 2, dtype=np.float32)
        o_cam, d_cam = oracle.get_rays(cam, u, v, rng)
        lo = np.asarray(scene.world_min, np.float32)
        hi = np.asarray(scene.world_max, np.float32)
        span = np.minimum(hi - lo, 50.0)
        o_b = ((lo + hi) / 2 + (rng.random((n - n // 2, 3)) - 0.5) * span)
        d_b = rng.standard_normal((n - n // 2, 3))
        o = np.concatenate([o_cam, o_b]).astype(np.float32)
        d = np.concatenate([d_cam, d_b]).astype(np.float32)

        sn = oracle.scene_to_np(scene)
        sn64 = oracle.SceneNp(*[a.astype(np.float64)
                                if a.dtype == np.float32 else a
                                for a in sn])
        exact = oracle.closest_hit(sn64, o.astype(np.float64),
                                   d.astype(np.float64), t_min, 3.0e38)

        runs = {}
        for accel in args.accels.split(","):
            if accel == "brute":
                runs["brute"] = functools.partial(
                    intersect.brute_force_closest, scene,
                    t_min=jnp.float32(t_min), t_max=intersect.BIG_T)
            elif accel == "tensor":
                for mode in args.precisions.split(","):
                    os.environ["PT_SWEEP_PRECISION"] = mode
                    runs[f"tensor/{mode}"] = jax.jit(
                        make_tensor_closest_hit(scene, t_min))
                    # trace now, under this mode (read at trace time)
                    runs[f"tensor/{mode}"](jnp.asarray(o[:8]),
                                           jnp.asarray(d[:8]))
                os.environ.pop("PT_SWEEP_PRECISION", None)
            elif accel == "pallas":
                runs["pallas"] = jax.jit(pallas_sweep.make_pallas_closest_hit(
                    scene, t_min, interpret=interpret))
            elif accel == "bvh":
                runs["bvh"] = jax.jit(make_bvh_closest_hit(
                    scene, build_lbvh(scene), t_min))
        bar = FLIP_BAR
        for name, fn in runs.items():
            c = oracle.compare_hits(exact, fn(jnp.asarray(o), jnp.asarray(d)))
            if name == "brute":  # runs first: the f32 reference's own rate
                bar = max(FLIP_BAR, c["flip_rate"])
            c.update(scene=scene_name, accel=name, flip_bar=bar,
                     verdict="PASS" if c["flip_rate"] <= bar else "FAIL")
            ok &= c["verdict"] == "PASS"
            print(json.dumps(c), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
