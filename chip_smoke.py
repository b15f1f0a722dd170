"""Smoke test of the render path on the GPU, in one process.

    python chip_smoke.py             # one card: phases (a)-(d), then the
                                     # reference checks
    python chip_smoke.py --cards 4   # four cards: the sharded phases only

One card runs, through the same entry points as ``bench.py`` and the CLI
(accel="auto"):

  (a) bunny at the bench shape (640x360, 8 spp, depth 4);
  (b) the reference's own world (``--scene triangle``) at 800x450, 4 spp,
      depth 50;
  (c) the Cornell preset ``cornell-full`` (NEE: shadow queries);
  (d) three ``render/diff.py`` train steps on ``cornell-diff`` at scale 0.25;

then compares every accel with the brute-force reference on a full 57,600
ray chunk of bunny and triangle camera and bounce rays, renders the test
world against its golden image, and runs the ``gpu``-marked tests.

Four cards render ``combined-1080p`` at scale 0.25 sharded over a
(rays=4, spp=1) and a (2, 2) mesh, take one sharded train step, and compare
each with the same configuration on one card.

Prints the card's name and power limit, one JSON line per phase (compile
and wall seconds, rates, each comparison with its tolerance), and — only
if every phase passed — the last line
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Exits nonzero, without that line, when JAX finds no GPU or any phase fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

ONE_CARD_PHASES = ("bunny_bench", "triangle_deep", "cornell_nee",
                   "train_cornell_diff", "accel_vs_brute", "golden",
                   "gpu_tests")
FOUR_CARD_PHASES = ("sharded_combined", "sharded_train")

FLIP_BAR = 5e-5       # winner flips per ray vs brute (tools/sweep_validate)
T_REL_BAR = 1e-5      # relative t error on agreeing winners
GOLDEN_ATOL = 2e-3    # the golden image's own bar (tests/test_golden.py)
SHARD_ATOL = 1e-5     # fp summation order (tests/test_parallel.py)
OUT_DIR = os.path.join("chiprun_out", "smoke")


def phases_for(cards: int) -> tuple:
    return FOUR_CARD_PHASES if cards == 4 else ONE_CARD_PHASES


def last_line(device: dict) -> str:
    """The contract line: ``ok`` and the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: getattr(m, k, None) for k in keys}


def _timed_render(cfg, scene, cam, iters: int, with_memory=False):
    """Compile and run the single-card renderer (bench.py's path). Returns
    (the seed-0 image, record); the timed runs use seeds 1..iters."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pathtracer_tpu.render.renderer import (make_renderer, prepare_bvh,
                                                resolved_accel)
    t0 = time.perf_counter()
    bvh = jax.block_until_ready(prepare_bvh(cfg, scene))
    bvh_s = time.perf_counter() - t0
    render = make_renderer(cfg, with_bvh=bvh is not None, with_stats=True)
    t0 = time.perf_counter()
    compiled = render.lower(scene, bvh, cam, jnp.int32(0)).compile()
    compile_s = time.perf_counter() - t0
    img = np.asarray(compiled(scene, bvh, cam, jnp.int32(0))[0])
    dts = []
    for i in range(iters):
        t0 = time.perf_counter()
        out, n_exec = compiled(scene, bvh, cam, jnp.int32(i + 1))
        n_exec = np.asarray(n_exec)
        jax.block_until_ready(out)
        dts.append(time.perf_counter() - t0)
    dt = sum(dts) / len(dts)
    nominal = cfg.num_pixels * cfg.spp * cfg.max_depth
    rec = {"accel": resolved_accel(cfg),
           "prims": int(scene.num_prims),
           "shape": [cfg.width, cfg.height, cfg.spp, cfg.max_depth],
           "compile_s": compile_s, "bvh_build_s": bvh_s, "render_s": dts,
           "nominal_mrays_per_s": nominal / dt / 1e6,
           "executed_mrays_per_s": float(n_exec[0]) / dt / 1e6,
           "executed_queries": int(n_exec[0]),
           "shadow_queries": int(n_exec[1]),
           "finite": bool(np.isfinite(img).all()),
           "mean": float(img.mean())}
    rec["ok"] = (rec["finite"] and img.shape == (cfg.height, cfg.width, 3)
                 and rec["mean"] > 0.0)
    if with_memory:
        rec["memory_analysis"] = _memory(compiled)
    return img, rec


def _save(name, img):
    from pathtracer_tpu.io.png import write_png
    os.makedirs(OUT_DIR, exist_ok=True)
    write_png(os.path.join(OUT_DIR, name + ".png"), img)


def phase_bunny_bench(width=640, height=360, spp=8, depth=4,
                      ray_chunk=57600, iters=2):
    from pathtracer_tpu.config import RenderConfig
    from pathtracer_tpu.scene.worlds import get_world
    scene, cam = get_world("bunny")
    cfg = RenderConfig(width=width, height=height, spp=spp, max_depth=depth,
                       ray_chunk=ray_chunk, scene="bunny")
    img, rec = _timed_render(cfg, scene, cam, iters, with_memory=True)
    _save("bunny", img)
    return rec


def phase_triangle_deep(width=800, height=450, spp=4, depth=50,
                        ray_chunk=45000, iters=1):
    from pathtracer_tpu.config import RenderConfig
    from pathtracer_tpu.scene.worlds import get_world
    scene, cam = get_world("triangle")
    cfg = RenderConfig(width=width, height=height, spp=spp, max_depth=depth,
                       ray_chunk=ray_chunk, scene="triangle")
    img, rec = _timed_render(cfg, scene, cam, iters)
    _save("triangle", img)
    return rec


def phase_cornell_nee(scale=1.0, iters=1):
    from pathtracer_tpu.presets import get_preset, scale_config
    scene, cam, cfg = get_preset("cornell-full")
    cfg = scale_config(cfg, scale)
    img, rec = _timed_render(cfg, scene, cam, iters)
    rec["ok"] = rec["ok"] and rec["shadow_queries"] > 0
    _save("cornell", img)
    return rec


def _train_setup(scale):
    """cornell-diff at ``scale``: albedo perturbed away from the scene's,
    target rendered from the scene itself."""
    import jax
    import jax.numpy as jnp

    from pathtracer_tpu.presets import get_preset, scale_config
    from pathtracer_tpu.render import diff, renderer
    scene, cam, cfg = get_preset("cornell-diff")
    cfg = scale_config(cfg, scale).replace(ray_chunk=64)
    rows, cols = renderer.padded_pixel_grid(cfg, cfg.ray_chunk)
    target = diff.render_linear(scene, None, cam, jax.random.PRNGKey(0),
                                rows, cols, cfg, cfg.spp)[:cfg.num_pixels]
    params = diff.scene_params(scene)
    params = dict(params, albedo=jnp.clip(params["albedo"] * 0.7, 0, 1))
    return scene, cam, cfg, target, params


def phase_train_cornell_diff(scale=0.25, steps=3):
    import jax
    import numpy as np
    import optax

    from pathtracer_tpu.render import diff
    scene, cam, cfg, target, params = _train_setup(scale)
    opt = optax.adam(0.05)
    step = diff.make_train_step(cfg, opt)
    opt_state = opt.init(params)
    t0 = time.perf_counter()
    compiled = step.lower(params, opt_state, scene, None, cam, target,
                          0).compile()
    compile_s = time.perf_counter() - t0
    losses, dts = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        # a fixed seed: one noise realization, so the objective is
        # deterministic and its minimum is the scene's own albedo
        params, opt_state, loss = compiled(params, opt_state, scene, None,
                                           cam, target, 0)
        losses.append(float(loss))
        dts.append(time.perf_counter() - t0)
    finite = all(np.isfinite(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: np.asarray(x).sum(), params))))
    return {"shape": [cfg.width, cfg.height, cfg.spp, cfg.max_depth],
            "accel": cfg.accel, "compile_s": compile_s, "step_s": dts,
            "losses": losses, "finite": bool(finite),
            "ok": bool(finite and np.isfinite(losses).all()
                       and losses[-1] < losses[0])}


def _chunk_rays(scene, cam, n=57600, seed=0):
    """One ``n``-ray chunk, as tools/sweep_validate.py builds it: half
    camera rays (jittered over the frame), half bounce rays — origins
    uniform in the scene's bounds clamped to 50 units a side, around the
    geometry, random directions — away from the camera's well-conditioned
    region."""
    import jax.numpy as jnp
    import numpy as np

    from pathtracer_tpu.core import camera as camera_mod
    rng = np.random.default_rng(seed)
    nc = n // 2
    u = jnp.asarray(rng.random(nc), jnp.float32)
    v = jnp.asarray(rng.random(nc), jnp.float32)
    zeros = jnp.zeros(nc, jnp.float32)
    o, d, _ = camera_mod.get_rays(cam, u, v, zeros, zeros, zeros)
    lo = np.asarray(scene.world_min, np.float32)
    hi = np.asarray(scene.world_max, np.float32)
    span = np.minimum(hi - lo, 50.0)
    ob = (lo + hi) / 2 + (rng.random((n - nc, 3)) - 0.5) * span
    db = rng.standard_normal((n - nc, 3))
    return (jnp.concatenate([o, jnp.asarray(ob, jnp.float32)]),
            jnp.concatenate([d, jnp.asarray(db, jnp.float32)]), nc)


def phase_accel_vs_brute(n=57600, n64=4096):
    """Every accel against brute on a full ``n``-ray chunk per scene
    (winner flips over the chunk), and the t error of each accel and of
    brute against a float64 oracle on ``n64`` of its rays (half camera,
    half bounce): the f32 brute reference is itself off the exact t by up
    to ~5e-5 relative on large-extent spheres, so the t bar is 1e-5
    relative added over brute's own p99 error."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pathtracer_tpu import oracle
    from pathtracer_tpu.accel.lbvh import build_lbvh
    from pathtracer_tpu.config import K_T_MIN
    from pathtracer_tpu.ops import intersect
    from pathtracer_tpu.ops.pallas_sweep import make_pallas_closest_hit
    from pathtracer_tpu.ops.tensor_sweep import make_tensor_closest_hit
    from pathtracer_tpu.ops.traversal import (make_bvh_closest_hit,
                                              pack_fat_nodes, traverse)
    from pathtracer_tpu.scene.worlds import get_world

    rec = {"flip_bar": FLIP_BAR, "t_rel_bar_over_brute": T_REL_BAR,
           "reference": "brute (elementwise f32); float64 oracle for t",
           "t_min": K_T_MIN, "rays": n, "rays_f64": n64, "checks": []}
    ok = True
    for name in ("bunny", "triangle"):
        scene, cam = get_world(name)
        bvh = build_lbvh(scene)
        sn = oracle.scene_to_np(scene)
        sn64 = oracle.SceneNp(*[a.astype(np.float64)
                                if a.dtype == np.float32 else a
                                for a in sn])
        accels = {
            "tensor": make_tensor_closest_hit(scene, K_T_MIN),
            "pallas": make_pallas_closest_hit(scene, K_T_MIN),
            "bvh": make_bvh_closest_hit(scene, bvh, K_T_MIN),
        }
        o, d, nc = _chunk_rays(scene, cam, n)
        sub = np.r_[0:n64 // 2, nc:nc + n64 // 2]
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(intersect.brute_force_closest)(
                scene, o, d, jnp.float32(K_T_MIN), intersect.BIG_T)
        exact = oracle.closest_hit(
            sn64, np.asarray(o, np.float64)[sub],
            np.asarray(d, np.float64)[sub], K_T_MIN, 3.0e38)
        ref64 = oracle.compare_hits(exact, [np.asarray(x)[sub]
                                            for x in ref])
        for accel, fn in accels.items():
            fn = jax.jit(fn)
            got = jax.block_until_ready(fn(o, d))
            dts = []
            for _ in range(5):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(o, d))
                dts.append(time.perf_counter() - t0)
            c = oracle.compare_hits(ref, got)
            # one n-ray query, median of 5 host-clock runs (the kernel
            # beside the plain version XLA compiles)
            c["query_ms"] = sorted(dts)[2] * 1e3
            c64 = oracle.compare_hits(exact, [np.asarray(x)[sub]
                                              for x in got])
            c.update(scene=name, accel=accel,
                     camera_flips=oracle.compare_hits(
                         [x[:nc] for x in ref], [x[:nc] for x in got])[
                             "flips"],
                     t_rel_p99_f64=c64["t_rel_p99"],
                     t_rel_max_f64=c64["t_rel_max"],
                     brute_t_rel_p99_f64=ref64["t_rel_p99"],
                     brute_t_rel_max_f64=ref64["t_rel_max"])
            c["ok"] = (c["flip_rate"] <= FLIP_BAR
                       and c64["t_rel_p99"] <= ref64["t_rel_p99"] + T_REL_BAR)
            ok &= c["ok"]
            rec["checks"].append(c)
        # the traversal's while-loop step count on the chunk's camera rays
        nodes = pack_fat_nodes(scene, bvh)
        steps = jax.jit(lambda o, d: traverse(
            nodes, o, d, jnp.float32(K_T_MIN), intersect.BIG_T,
            with_steps=True)[3])(o[:nc], d[:nc])
        rec[f"{name}_bvh_steps_camera_rays"] = int(steps)
    rec["ok"] = bool(ok)
    return rec


def phase_golden():
    import numpy as np

    from pathtracer_tpu.config import RenderConfig
    from pathtracer_tpu.render.renderer import render_image, resolved_accel
    from pathtracer_tpu.scene.worlds import test_world
    scene, cam = test_world()
    golden = np.load(os.path.join("tests", "golden",
                                  "test_world_64x36_s4d4.npy"))
    cfg = RenderConfig(width=64, height=36, spp=4, max_depth=4,
                       ray_chunk=2304, scene="test", seed=0)
    rec = {"atol": GOLDEN_ATOL, "checks": []}
    for accel in ("brute", "auto"):
        img = np.asarray(render_image(scene, cam, cfg.replace(accel=accel)))
        bad = int((~np.isclose(img, golden, atol=GOLDEN_ATOL)).sum())
        rec["checks"].append({
            "accel": resolved_accel(cfg.replace(accel=accel)),
            "max_abs_diff": float(np.abs(img - golden).max()),
            "values_over_atol": bad})
    # brute must match outright; the dense/traversal paths may differ on
    # at most 2 razor-edge pixels (tests/test_golden.py's bar)
    rec["ok"] = (rec["checks"][0]["values_over_atol"] == 0
                 and rec["checks"][1]["values_over_atol"] <= 2 * 3)
    return rec


def phase_gpu_tests():
    import pytest
    os.environ["PT_TEST_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "tests/"])
    return {"pytest_rc": int(rc), "ok": int(rc) == 0}


def _compare_images(a, b) -> dict:
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    return {"max_abs_diff": float(np.abs(a - b).max()),
            "values_over_atol": int((~np.isclose(a, b, atol=SHARD_ATOL,
                                                 rtol=0)).sum()),
            "atol": SHARD_ATOL}


def phase_sharded_combined(scale=0.25, ray_chunk=8100, devices=None):
    """combined-1080p sharded over (4, 1) and (2, 2) meshes vs one card.
    ray_chunk 8100 keeps the chunk layout (and so every RNG key) the same
    on one card and on both meshes; only fp summation order differs."""
    import jax
    import numpy as np

    from pathtracer_tpu.parallel import make_mesh, make_sharded_renderer
    from pathtracer_tpu.presets import get_preset, scale_config
    devices = devices or jax.devices()[:4]
    scene, cam, cfg = get_preset("combined-1080p")
    cfg = scale_config(cfg, scale).replace(ray_chunk=ray_chunk)
    single, rec = _timed_render(cfg, scene, cam, iters=1)
    from pathtracer_tpu.render.renderer import prepare_bvh
    bvh = prepare_bvh(cfg, scene)
    rec = {"shape": rec["shape"], "accel": rec["accel"],
           "one_card": rec, "meshes": []}
    ok = rec["one_card"]["ok"]
    for spp_axis in (1, 2):
        mesh = make_mesh(devices, spp_axis_size=spp_axis)
        render = make_sharded_renderer(cfg, mesh, with_bvh=bvh is not None)
        t0 = time.perf_counter()
        img = np.asarray(render(scene, bvh, cam, cfg.seed))
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        img = np.asarray(render(scene, bvh, cam, cfg.seed))
        c = _compare_images(img, single)
        c.update(mesh=dict(mesh.shape), first_call_s=first_s,
                 render_s=time.perf_counter() - t0)
        c["ok"] = c["values_over_atol"] == 0
        ok &= c["ok"]
        rec["meshes"].append(c)
    rec["ok"] = bool(ok)
    return rec


def phase_sharded_train(scale=0.25, devices=None):
    """One sharded train step on a (4, 1) mesh vs the same step on one
    card: same chunk layout, so loss and updated params agree to fp
    summation order. Plain SGD, so the parameter update is linear in the
    gradient (Adam's normalisation would amplify fp noise on near-zero
    gradients)."""
    import jax
    import numpy as np
    import optax

    from pathtracer_tpu.parallel import make_mesh
    from pathtracer_tpu.render import diff
    devices = devices or jax.devices()[:4]
    scene, cam, cfg, target, params = _train_setup(scale)
    opt = optax.sgd(0.05)
    opt_state = opt.init(params)
    out = {}
    for name, mesh in (("one_card", None),
                       ("sharded", make_mesh(devices, spp_axis_size=1))):
        step = diff.make_train_step(cfg, opt, mesh=mesh)
        t0 = time.perf_counter()
        p, _, loss = step(params, opt_state, scene, None, cam, target, 0)
        out[name] = (jax.tree_util.tree_map(np.asarray, p), float(loss),
                     time.perf_counter() - t0)
    p1, l1, s1 = out["one_card"]
    p4, l4, s4 = out["sharded"]
    dp = max(float(np.abs(p1[k] - p4[k]).max()) for k in p1)
    rec = {"loss_one_card": l1, "loss_sharded": l4,
           "loss_rel_diff": abs(l1 - l4) / max(abs(l1), 1e-30),
           "param_max_abs_diff": dp, "rtol": 1e-5, "atol": SHARD_ATOL,
           "first_call_s": {"one_card": s1, "sharded": s4}}
    rec["ok"] = bool(np.isfinite(l4) and rec["loss_rel_diff"] <= 1e-5
                     and dp <= SHARD_ATOL)
    return rec


PHASES = {
    "bunny_bench": phase_bunny_bench,
    "triangle_deep": phase_triangle_deep,
    "cornell_nee": phase_cornell_nee,
    "train_cornell_diff": phase_train_cornell_diff,
    "accel_vs_brute": phase_accel_vs_brute,
    "golden": phase_golden,
    "gpu_tests": phase_gpu_tests,
    "sharded_combined": phase_sharded_combined,
    "sharded_train": phase_sharded_train,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, default=1, choices=(1, 4),
                   help="4: run only the sharded four-card phases")
    args = p.parse_args(argv)

    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {platform!r}); not run",
              file=sys.stderr)
        return 2
    if len(jax.devices()) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs, "
              f"JAX sees {len(jax.devices())}", file=sys.stderr)
        return 2
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.getcwd())
    from pathtracer_tpu import runtime
    runtime.enable_compile_cache()
    print(runtime.gpu_name_and_power(), flush=True)

    ok = True
    for name in phases_for(args.cards):
        t0 = time.perf_counter()
        try:
            rec = PHASES[name]()
        except Exception as e:  # a failed phase fails the run
            traceback.print_exc()
            rec = {"ok": False, "error": f"{type(e).__name__}: {e}"[:2000]}
        rec = {"phase": name, **rec, "wall_s": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        ok &= bool(rec["ok"])
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(last_line(runtime.device_info()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
