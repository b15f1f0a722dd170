"""Multi-device sharding tests on the 8-device virtual CPU mesh (conftest
forces JAX_PLATFORMS=cpu with xla_force_host_platform_device_count=8)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.accel.lbvh import build_lbvh
from pathtracer_tpu.config import RenderConfig
from pathtracer_tpu.parallel import (RAYS_AXIS, SPP_AXIS, make_mesh,
                                     make_sharded_renderer)
from pathtracer_tpu.render.renderer import make_renderer
from pathtracer_tpu.scene.worlds import test_world

CFG = RenderConfig(width=32, height=16, spp=2, max_depth=3,
                   accel="bvh", ray_chunk=64, scene="test")


def test_mesh_shapes():
    mesh = make_mesh(jax.devices()[:8], spp_axis_size=2)
    assert mesh.shape[RAYS_AXIS] == 4
    assert mesh.shape[SPP_AXIS] == 2
    with pytest.raises(ValueError):
        make_mesh(jax.devices()[:8], spp_axis_size=3)


def test_sharded_matches_single_chip():
    """Same seed + same chunk layout => sharded == single-chip render up to
    fp summation order (determinism across device layouts, SURVEY §5)."""
    scene, cam = test_world()
    bvh = build_lbvh(scene)
    single = make_renderer(CFG, with_bvh=True)(scene, bvh, cam, 7)

    mesh = make_mesh(jax.devices()[:8], spp_axis_size=1)
    sharded = make_sharded_renderer(CFG, mesh)(scene, bvh, cam, 7)

    assert sharded.shape == (16, 32, 3)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               atol=1e-5)


def test_sharded_spp_axis():
    """Sample-parallel axis: (4 rays x 2 spp) mesh accumulates the same
    global sample set via psum."""
    scene, cam = test_world()
    bvh = build_lbvh(scene)
    single = make_renderer(CFG, with_bvh=True)(scene, bvh, cam, 3)

    mesh = make_mesh(jax.devices()[:8], spp_axis_size=2)
    sharded = make_sharded_renderer(CFG, mesh)(scene, bvh, cam, 3)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               atol=1e-5)


def test_sharded_streamed_march_matches_single_chip():
    """The LBVH traversal under shard_map on the
    8-device mesh must match the single-device image. Chunk layout
    matches (ray_chunk 512 both sides), so the RNG keys are identical;
    tolerance only covers fp summation order."""
    from pathtracer_tpu.scene.worlds import get_world
    cfg = RenderConfig(width=64, height=32, spp=2, max_depth=3,
                       accel="bvh", ray_chunk=512, scene="random")
    scene, cam = get_world("random")
    bvh = build_lbvh(scene)
    single = make_renderer(cfg, with_bvh=True)(scene, bvh, cam, 7)
    mesh = make_mesh(jax.devices()[:8], spp_axis_size=2)
    sharded = make_sharded_renderer(cfg, mesh)(scene, bvh, cam, 7)
    assert np.isfinite(np.asarray(sharded)).all()
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               atol=1e-5)


def test_spp_not_divisible_raises():
    mesh = make_mesh(jax.devices()[:8], spp_axis_size=2)
    with pytest.raises(ValueError):
        make_sharded_renderer(CFG.replace(spp=3), mesh)


def test_sharded_nee_matches_single_chip():
    """Config-5 composition: NEE + sharded rendering. Shadow rays and light
    sampling run per-device inside shard_map; result matches single-chip."""
    from pathtracer_tpu.scene.scene import SceneBuilder
    from pathtracer_tpu.core.camera import make_camera

    b = SceneBuilder()
    g = b.add_lambertian((0.7, 0.6, 0.5))
    b.add_sphere((0, -100.5, -3), 100.0, g)
    e = b.add_emissive((24.0, 20.0, 16.0))
    b.add_sphere((0, 3.0, -3), 0.6, e)
    scene = b.build()
    cam = make_camera((0, 1.2, 2.0), (0, 0, -3), 55, 2.0, aperture=0,
                      focus_dist=5)

    cfg = RenderConfig(width=32, height=16, spp=2, max_depth=3,
                       accel="tensor", ray_chunk=64, sky=False, nee=True,
                       scene="test")
    single = make_renderer(cfg, with_bvh=False)(scene, None, cam, 9)
    mesh = make_mesh(jax.devices()[:8], spp_axis_size=2)
    sharded = make_sharded_renderer(cfg, mesh)(scene, None, cam, 9)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               atol=1e-5)
