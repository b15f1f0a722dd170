"""Tensor-sweep closest-hit: matmul-form intersection must agree with the
factored brute-force tests (ops/intersect.py) on hits, ts and winners."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.config import RenderConfig
from pathtracer_tpu.ops import intersect, tensor_sweep
from pathtracer_tpu.render.renderer import render_image
from pathtracer_tpu.scene.worlds import get_world, test_world


def _rays(cam, n, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.random(n).astype(np.float32)
    v = rng.random(n).astype(np.float32)
    o = jnp.tile(jnp.asarray(cam.position)[None, :], (n, 1))
    d = (cam.lower_left[None, :] + u[:, None] * cam.horizontal[None, :]
         + v[:, None] * cam.vertical[None, :] - o)
    return o, d


@pytest.mark.parametrize("maker", [
    lambda: test_world(),
    lambda: get_world("triangle", total_count=80),
    lambda: get_world("random"),
])
def test_matches_brute_force(maker):
    scene, cam = maker()
    o, d = _rays(cam, 512)
    t_min, t_max = jnp.float32(1e-3), intersect.BIG_T

    bidx, bt, bvalid = intersect.brute_force_closest(scene, o, d, t_min,
                                                     t_max)
    tables = tensor_sweep.pack_sweep_tables(scene)
    tidx, tt, tvalid = tensor_sweep.tensor_closest(tables, o, d, t_min,
                                                   t_max)

    bvalid = np.asarray(bvalid)
    tvalid = np.asarray(tvalid)
    # hit/miss must agree except at razor-edge cases (ulp-level association
    # differences between the factored and matmul forms)
    agree = bvalid == tvalid
    assert agree.mean() > 0.998, f"valid mismatch rate {1 - agree.mean()}"
    both = agree & bvalid
    same_winner = both & (np.asarray(bidx) == np.asarray(tidx))
    assert same_winner[both].mean() > 0.995
    np.testing.assert_allclose(np.asarray(tt)[same_winner],
                               np.asarray(bt)[same_winner],
                               rtol=2e-4, atol=2e-4)


def test_render_tensor_close_to_brute():
    """Whole renders through both accel paths agree to MC-free tolerance
    (same seeds, same per-sample keys -> only intersection numerics differ)."""
    scene, cam = test_world()
    cfg_b = RenderConfig(width=24, height=16, spp=2, max_depth=3,
                         accel="brute", ray_chunk=384, scene="test")
    img_b = np.asarray(render_image(scene, cam, cfg_b))
    img_t = np.asarray(render_image(scene, cam, cfg_b.replace(accel="tensor")))
    # identical RNG and shading; only razor-edge hits may differ
    close = np.isclose(img_b, img_t, atol=5e-3).mean()
    assert close > 0.999, close


def test_small_scene_tile_shrink():
    scene, _ = test_world()
    tables = tensor_sweep.pack_sweep_tables(scene, tile=2048)
    assert tables.cols.shape[0] == 1
    assert tables.cols.shape[2] == 128 * tensor_sweep.OUTS


@pytest.mark.parametrize("world", ["test", "triangle", "random", "bunny"])
def test_sweep_precision_vs_float64(world):
    """The default "fused6" sweep against a float64 oracle (the factored
    reference tests at f64, oracle.closest_hit): t error (p99) at most 1e-5
    relative over the f32 brute scan's own, and winner flips at razor-edge
    noise — at most 2 of these 2,048 rays (the 5e-5 bar of
    tools/sweep_validate.py needs a full 57,600-ray chunk, which
    chip_smoke.py checks on the card)."""
    from pathtracer_tpu import oracle
    scene, cam = get_world(world)
    o, d = _rays(cam, 2048, seed=3)
    sn = oracle.scene_to_np(scene)
    sn64 = oracle.SceneNp(*[a.astype(np.float64) if a.dtype == np.float32
                            else a for a in sn])
    exact = oracle.closest_hit(sn64, np.asarray(o, np.float64),
                               np.asarray(d, np.float64), 1e-3, 3.0e38)
    t_min = jnp.float32(1e-3)
    brute = oracle.compare_hits(exact, intersect.brute_force_closest(
        scene, o, d, t_min, intersect.BIG_T))
    tables = tensor_sweep.pack_sweep_tables(scene)
    sweep = oracle.compare_hits(exact, tensor_sweep.tensor_closest(
        tables, o, d, t_min, intersect.BIG_T))
    assert sweep["flips"] <= brute["flips"] + 2, (sweep, brute)
    assert sweep["t_rel_p99"] <= brute["t_rel_p99"] + 1e-5, (sweep, brute)
