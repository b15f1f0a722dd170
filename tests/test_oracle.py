"""Parity against the CPU reference oracle (pathtracer_tpu/oracle.py).

This is the self-controlled parity claim: instead of scoring against the
reference's stale milestone PNGs (whose generator demonstrably differs from
the shipped source — tools/fit_reference_world.py), the JAX
renderer is compared to a direct NumPy port of the reference's exact
algorithm (main.cu:21-37 integrator, cuda_object.h:45-90 intersections,
material.h:28-61 scatter, camera.h:58-64 rays) over the SAME scene
construction. Both sides are controlled, so converged images must agree
within Monte-Carlo noise — no historical-artifact floor.

The tolerance is self-calibrating (oracle.compare_to_jax): the
oracle-vs-JAX difference is measured against the JAX renderer's
difference from ITSELF at matched spp (two seeds). Under the null
hypothesis the two difference images are identically distributed; a bug in
either port (camera convention, scatter semantics, intersection accept
rules, sky quirk) shows up as cross-noise systematically exceeding
self-noise.
"""
import numpy as np
import pytest

from pathtracer_tpu import oracle
from pathtracer_tpu.scene import worlds

# Small frames keep the O(R x N) NumPy oracle affordable in-suite; the
# committed PARITY.md numbers come from larger CLI runs of the same code.
W, H = 64, 36


def _run(scene_name, spp, depth, accel="tensor"):
    scene, cam = worlds.get_world(scene_name)
    mean, _ = oracle.render(scene, cam, W, H, spp, depth, seed=7)
    stats = oracle.compare_to_jax(scene, cam, W, H, spp, depth, mean,
                                  seed=7, scene_name=scene_name,
                                  accel=accel)
    return stats


def _assert_parity(stats, scene_name):
    # means agree globally far below per-pixel noise (the estimators are
    # unbiased for the same integral); 0.004 in linear radiance ~ 1/2% of
    # a mid-grey pixel
    assert abs(stats["mean_signed_diff"]) < 0.004, (scene_name, stats)
    # cross-renderer noise is the same size as same-renderer noise: a
    # semantic difference (wrong camera/scatter/accept rule) inflates the
    # cross statistics multiplicatively, not by 35%
    assert stats["mean_abs_cross"] <= 1.35 * stats["mean_abs_self"] + 5e-3, \
        (scene_name, stats)
    assert stats["p99_cross"] <= 1.5 * stats["p99_self"] + 0.02, \
        (scene_name, stats)


def test_oracle_parity_test_world():
    _assert_parity(_run("test", spp=24, depth=8), "test")


def test_oracle_parity_triangle_world():
    # the reference's active scene (main.cu:123,169): 601 objects incl.
    # the icosphere mesh, glass + metal spheres
    _assert_parity(_run("triangle", spp=12, depth=8), "triangle")


@pytest.mark.slow
def test_oracle_parity_random_world():
    _assert_parity(_run("random", spp=12, depth=8), "random")


def test_oracle_depth_exhaustion_quirk():
    """Depth-1 renders isolate the reference quirk: every ray that HITS
    scatters once, runs out of depth, and must return
    sky(scattered dir) * attenuation — not black, not sky(camera dir).
    A converged low-depth comparison pins the quirk semantics exactly
    (misses and hits both covered)."""
    stats = _run("test", spp=24, depth=1)
    assert abs(stats["mean_signed_diff"]) < 0.004, stats
    assert stats["mean_abs_cross"] <= 1.35 * stats["mean_abs_self"] + 5e-3, \
        stats


def test_oracle_closest_hit_matches_brute():
    """The oracle's factored-formula closest hit (cuda_object.h:45-90
    forms) agrees with the repo's affine-feature sweep on which primitive
    wins — two independent numerical paths, same verdicts away from
    razor-edge ties."""
    import jax.numpy as jnp

    from pathtracer_tpu.ops import intersect

    scene, cam = worlds.get_world("test")
    sn = oracle.scene_to_np(scene)
    rng = np.random.default_rng(3)
    n = 512
    u = rng.random(n, dtype=np.float32)
    v = rng.random(n, dtype=np.float32)
    o, d = oracle.get_rays(cam, u, v, rng)
    idx_o, t_o, valid_o = oracle.closest_hit(sn, o, d, 1e-3, float(oracle.INF))
    idx_j, t_j, valid_j = intersect.brute_force_closest(
        scene, jnp.asarray(o), jnp.asarray(d), jnp.float32(1e-3),
        intersect.BIG_T)
    idx_j, t_j, valid_j = (np.asarray(idx_j), np.asarray(t_j),
                           np.asarray(valid_j))
    assert np.array_equal(valid_o, valid_j)
    agree = idx_o[valid_o] == idx_j[valid_o]
    # ulp-level association-order differences may flip a razor-edge winner
    assert agree.mean() > 0.995, agree.mean()
    np.testing.assert_allclose(t_o[valid_o & (idx_o == idx_j)],
                               t_j[valid_o & (idx_o == idx_j)],
                               rtol=2e-5, atol=2e-5)
