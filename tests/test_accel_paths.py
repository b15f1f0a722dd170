"""The closest-hit paths that stay on the GPU — LBVH traversal, the XLA
dense sweep — against the brute-force reference, query by query and image
by image, plus the size rule that picks between them (config.resolve_accel).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu import config
from pathtracer_tpu.accel.lbvh import build_lbvh
from pathtracer_tpu.config import K_SHADOW_T_MIN, K_T_MIN, RenderConfig
from pathtracer_tpu.core import camera as camera_mod
from pathtracer_tpu.ops import intersect
from pathtracer_tpu.ops.traversal import make_bvh_closest_hit
from pathtracer_tpu.render.renderer import render_image
from pathtracer_tpu.scene.worlds import get_world

WORLDS = {
    "test": lambda: get_world("test"),
    "triangle": lambda: get_world("triangle", total_count=120),
    "random": lambda: get_world("random"),
    "cornell": lambda: get_world("cornell"),
    "bunny": lambda: get_world("bunny"),
    "combined": lambda: get_world("combined"),
}


def _camera_rays(cam, n=1024, seed=0):
    rng = np.random.default_rng(seed)
    u = jnp.asarray(rng.random(n), jnp.float32)
    v = jnp.asarray(rng.random(n), jnp.float32)
    z = jnp.zeros(n, jnp.float32)
    o, d, _ = camera_mod.get_rays(cam, u, v, z, z, z)
    return o, d


def _shadow_rays(scene, n=1024, seed=1):
    """NEE-style segments between random points of the scene's bounds
    (clamped to 50 units a side, around the geometry), unnormalized so the
    target sits at t == 1."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(scene.world_min)
    hi = np.asarray(scene.world_max)
    span = np.minimum(hi - lo, 50.0)
    a, b = ((lo + hi) / 2 + (rng.random((2, n, 3)) - 0.5) * span)
    return jnp.asarray(a, jnp.float32), jnp.asarray(b - a, jnp.float32)


@pytest.mark.parametrize("kind", ["primary", "shadow"])
@pytest.mark.parametrize("world", list(WORLDS))
def test_lbvh_traversal_matches_brute(world, kind):
    """Same winner and the same t for camera rays and for shadow segments:
    the traversal runs the brute scan's own per-pair arithmetic, fused
    differently, so t agrees to a few f32 ulps of the scene's coordinate
    scale (the r=1000 ground spheres cancel ~1e3 x eps in half_b)."""
    scene, cam = WORLDS[world]()
    o, d = _camera_rays(cam)
    t_min = K_T_MIN
    if kind == "shadow":
        o, d = _shadow_rays(scene)
        t_min = K_SHADOW_T_MIN
    bi, bt, bv = intersect.brute_force_closest(
        scene, o, d, jnp.float32(t_min), intersect.BIG_T)
    vi, vt, vv = jax.jit(make_bvh_closest_hit(scene, build_lbvh(scene),
                                              t_min))(o, d)
    np.testing.assert_array_equal(np.asarray(vv), np.asarray(bv))
    m = np.asarray(bv)
    assert m.any()
    np.testing.assert_array_equal(np.asarray(vi)[m], np.asarray(bi)[m])
    scale = float(np.abs(np.asarray(scene.v0)).max()
                  + np.abs(np.asarray(scene.radius)).max())
    np.testing.assert_allclose(np.asarray(vt)[m], np.asarray(bt)[m],
                               rtol=1e-6,
                               atol=8 * np.finfo(np.float32).eps * scale)


@pytest.mark.parametrize("world", ["test", "triangle", "random", "cornell",
                                   "bunny"])
def test_accel_renders_agree(world):
    """bvh and tensor renders reproduce the brute render. The traversal
    runs brute's arithmetic: all pixels within 2e-3 but for 2 razor-edge
    pixels. The tensor sweep's affine (bf16-split) arithmetic decides
    razor-edge and self-intersection cases differently, and a path that
    diverges at any bounce moves its pixel: at most 3% of values off, and
    no bias in the mean."""
    scene, cam = WORLDS[world]()
    emissive = world == "cornell"
    cfg = RenderConfig(width=32, height=18, spp=2, max_depth=3,
                       ray_chunk=576, sky=not emissive, nee=emissive,
                       scene=world)
    ref = np.asarray(render_image(scene, cam, cfg.replace(accel="brute")))
    assert np.isfinite(ref).all() and ref.max() > 0
    img = np.asarray(render_image(scene, cam, cfg.replace(accel="bvh")))
    bad = ~np.isclose(img, ref, atol=2e-3)
    assert bad.sum() <= 2 * 3, (bad.sum(), np.abs(img - ref).max())
    img = np.asarray(render_image(scene, cam, cfg.replace(accel="tensor")))
    bad = ~np.isclose(img, ref, atol=2e-3)
    assert bad.mean() <= 0.03, bad.mean()
    assert abs(float(img.mean() - ref.mean())) <= 2e-3


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize("world", ["test", "cornell", "random", "triangle",
                                   "bunny", "combined"])
def test_resolve_accel_crossover(world, platform):
    """No crossover (PERF.md): at every scene size, from 3 to ~3.6k prims
    here, "auto" is the dense sweep — the Triton kernel on a GPU, the XLA
    sweep elsewhere — and the renderer builds no LBVH for it."""
    from pathtracer_tpu.render.renderer import prepare_bvh
    scene, _ = WORLDS[world]()
    want = "pallas" if platform == "gpu" else "tensor"
    assert config.resolve_accel("auto", platform=platform) == want
    cfg = RenderConfig(width=8, height=8, scene=world)
    assert prepare_bvh(cfg, scene) is None  # the CPU: auto -> tensor


def test_prepare_bvh_follows_resolved_accel():
    """The renderer builds an LBVH exactly when the accel resolves to bvh."""
    from pathtracer_tpu.render.renderer import prepare_bvh
    scene, _ = get_world("test")
    cfg = RenderConfig(width=8, height=8, scene="test")
    assert prepare_bvh(cfg.replace(accel="tensor"), scene) is None
    assert prepare_bvh(cfg.replace(accel="brute"), scene) is None
    bvh = prepare_bvh(cfg.replace(accel="bvh"), scene)
    assert bvh.num_leaves == scene.num_prims


def test_traversal_reports_steps():
    """with_steps: the while loop's trip count, at least the tree depth
    and at most the malformed-tree guard."""
    from pathtracer_tpu.ops.traversal import pack_fat_nodes, traverse
    scene, cam = get_world("random")
    nodes = pack_fat_nodes(scene, build_lbvh(scene))
    o, d = _camera_rays(cam, 256)
    idx, t, valid, steps = traverse(nodes, o, d, jnp.float32(K_T_MIN),
                                    intersect.BIG_T, with_steps=True)
    assert 1 < int(steps) <= 4 * nodes.fdata.shape[0]
    assert idx.shape == t.shape == valid.shape == (256,)
