"""BASELINE preset configurations (BASELINE.json "configs" 1-5)."""
import numpy as np
import pytest

from pathtracer_tpu.presets import combined_scene, get_preset
from pathtracer_tpu.render.renderer import render_image


@pytest.mark.parametrize("name,expect", [
    ("cornell-direct", dict(width=256, spp=16, max_depth=2)),
    ("cornell-full", dict(width=256, spp=64, max_depth=4)),
    ("bunny", dict(width=800, spp=128, max_depth=4)),
    ("combined-1080p", dict(width=1920, height=1080, spp=512)),
])
def test_preset_shapes(name, expect):
    scene, cam, cfg = get_preset(name)
    for k, v in expect.items():
        assert getattr(cfg, k) == v, (name, k)
    assert scene.num_prims > 0
    assert not cfg.sky or name == "bunny"


def test_unknown_preset():
    with pytest.raises(ValueError):
        get_preset("nope")


def test_combined_scene_contents():
    """Config 5 scene: Cornell room + bunny mesh + mirror/glass spheres +
    emissive light, all in one primitive table."""
    from pathtracer_tpu.scene.scene import (MAT_DIELECTRIC, MAT_EMISSIVE,
                                            MAT_LAMBERTIAN, MAT_METAL)
    scene, cam = combined_scene()
    assert scene.num_prims > 3616  # the bunny's 3,616 triangles dominate
    mtypes = set(np.asarray(scene.mat_type).tolist())
    assert {MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC,
            MAT_EMISSIVE} <= mtypes


def test_cornell_direct_proxy_render():
    """A downscaled config-1 render completes and the light is visible
    (emissive path end-to-end through the tensor sweep)."""
    scene, cam, cfg = get_preset("cornell-direct")
    cfg = cfg.replace(width=32, height=32, spp=2, ray_chunk=1024)
    img = np.asarray(render_image(scene, cam, cfg))
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.5  # the area light shows up


def test_cli_preset_accel_override(tmp_path):
    """--accel and --rr override a preset's config (used for running
    BASELINE configs on the production accel)."""
    from pathtracer_tpu.__main__ import build_parser
    args = build_parser().parse_args(
        ["--preset", "cornell-direct", "--accel", "bvh", "--rr"])
    assert args.accel == "bvh" and args.rr
    # default accel stays None so presets keep their own unless overridden
    args2 = build_parser().parse_args(["--preset", "cornell-direct"])
    assert args2.accel is None


def test_auto_accel_policy():
    """accel="auto" (the production default) is the dense sweep at every
    scene size — the H100 crossover table in PERF.md found no size where
    the LBVH traversal wins: the Triton kernel on a GPU, the XLA sweep
    elsewhere."""
    from pathtracer_tpu.config import RenderConfig, resolve_accel

    assert RenderConfig().accel == "auto"
    assert resolve_accel("auto", platform="gpu") == "pallas"
    assert resolve_accel("auto", platform="cpu") == "tensor"
    assert resolve_accel("auto") == "tensor"  # these tests run on the CPU
    # explicit choices pass through untouched
    for a in ("tensor", "pallas", "bvh", "brute"):
        assert resolve_accel(a) == a
        assert resolve_accel(a, platform="gpu") == a


def test_auto_accel_renders_and_matches_explicit():
    """A small render under accel="auto" is bit-identical to the explicit
    accel it resolves to (the policy only dispatches, never changes the
    query)."""
    import numpy as np
    from pathtracer_tpu.config import RenderConfig
    from pathtracer_tpu.render.renderer import render_image
    from pathtracer_tpu.scene.worlds import get_world

    scene, cam = get_world("test")
    base = dict(width=32, height=18, spp=2, max_depth=3, ray_chunk=576)
    auto = np.asarray(render_image(scene, cam,
                                   RenderConfig(accel="auto", **base)))
    expl = np.asarray(render_image(scene, cam,
                                   RenderConfig(accel="tensor", **base)))
    np.testing.assert_array_equal(auto, expl)


def test_cli_requires_gpu_without_platform(tmp_path, capsys):
    """No GPU and no --platform: the CLI refuses instead of silently
    rendering on the CPU."""
    from pathtracer_tpu.__main__ import main
    out = tmp_path / "t.png"
    assert main(["--scene", "test", "--width", "8", "--height", "8",
                 "--spp", "1", "-o", str(out)]) == 2
    assert "--platform cpu" in capsys.readouterr().err
    assert not out.exists()
