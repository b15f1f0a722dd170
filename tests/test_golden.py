"""Golden-image regression (SURVEY §4: the reference's milestone-PNG eyeball
diffing, made automatic). The golden was rendered on the CPU backend with
the brute path at a fixed seed; the stateless RNG makes the render a pure
function of (scene, cfg, seed), so any drift beyond fp-reassociation
tolerance is a real behavior change."""
import numpy as np

from pathtracer_tpu.config import RenderConfig
from pathtracer_tpu.render.renderer import render_image
from pathtracer_tpu.scene.worlds import test_world

GOLDEN = "tests/golden/test_world_64x36_s4d4.npy"
CFG = RenderConfig(width=64, height=36, spp=4, max_depth=4, accel="brute",
                   ray_chunk=2304, scene="test", seed=0)


def test_golden_test_world():
    scene, cam = test_world()
    img = np.asarray(render_image(scene, cam, CFG))
    golden = np.load(GOLDEN)
    np.testing.assert_allclose(img, golden, atol=2e-3)


def test_golden_accel_paths_agree(monkeypatch):
    """Every accel path reproduces the brute golden (the Triton kernel in
    interpret mode). Tolerance: all pixels within 2e-3 except razor-edge
    cases (grazing hits where matmul-vs-factored arithmetic legitimately
    diverges) — bounded to <=2 pixels rather than a loose fraction."""
    import functools

    from pathtracer_tpu.ops import pallas_sweep
    monkeypatch.setattr(pallas_sweep, "make_pallas_closest_hit",
                        functools.partial(
                            pallas_sweep.make_pallas_closest_hit,
                            interpret=True))
    scene, cam = test_world()
    golden = np.load(GOLDEN)
    for accel in ("tensor", "bvh", "pallas"):
        img = np.asarray(render_image(scene, cam, CFG.replace(accel=accel)))
        bad = ~np.isclose(img, golden, atol=2e-3)
        assert bad.sum() <= 2 * 3, (accel, bad.sum(), np.abs(
            img - golden).max())


GOLDEN_CORNELL = "tests/golden/cornell_48x48_s4d4_nee.npy"
CFG_CORNELL = RenderConfig(width=48, height=48, spp=4, max_depth=4,
                           accel="brute", ray_chunk=2304, scene="cornell",
                           sky=False, nee=True, seed=0)


def test_golden_cornell_nee():
    """Cornell + NEE + MIS + emissive light path (the reference has no
    emitter; this pins the extension's behavior)."""
    from pathtracer_tpu.scene.worlds import get_world
    scene, cam = get_world("cornell")
    img = np.asarray(render_image(scene, cam, CFG_CORNELL))
    golden = np.load(GOLDEN_CORNELL)
    np.testing.assert_allclose(img, golden, atol=2e-3)


# rendered on the CPU brute path from the vendored assets/bunny.obj
GOLDEN_BUNNY = "tests/golden/bunny_64x36_s2d3.npy"
CFG_BUNNY = RenderConfig(width=64, height=36, spp=2, max_depth=3,
                         accel="brute", ray_chunk=2304, scene="bunny",
                         seed=0)


def test_golden_bunny():
    """Flagship mesh scene (OBJ ingestion + mixed sphere/triangle scene)."""
    from pathtracer_tpu.scene.worlds import get_world
    scene, cam = get_world("bunny")
    img = np.asarray(render_image(scene, cam, CFG_BUNNY))
    golden = np.load(GOLDEN_BUNNY)
    np.testing.assert_allclose(img, golden, atol=2e-3)


def test_golden_bunny_bvh_agrees():
    """The large-scene path (LBVH traversal) on the flagship mesh."""
    from pathtracer_tpu.scene.worlds import get_world
    scene, cam = get_world("bunny")
    img = np.asarray(render_image(scene, cam,
                                  CFG_BUNNY.replace(accel="bvh")))
    golden = np.load(GOLDEN_BUNNY)
    bad = ~np.isclose(img, golden, atol=2e-3)
    assert bad.sum() <= 4 * 3, (bad.sum(), np.abs(img - golden).max())
