"""Triton dense-sweep kernel (ops/pallas_sweep.py) against the XLA sweep
and the brute-force reference. On the CPU the kernel runs in interpret
mode; the compiled kernel is checked by the ``gpu``-marked test, which
runs on a CUDA device only."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.ops import intersect, pallas_sweep, tensor_sweep
from pathtracer_tpu.scene.scene import SceneBuilder
from pathtracer_tpu.scene.worlds import get_world, test_world


def _rays(cam, n, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.random(n).astype(np.float32)
    v = rng.random(n).astype(np.float32)
    o = jnp.tile(jnp.asarray(cam.position)[None, :], (n, 1))
    d = (cam.lower_left[None, :] + u[:, None] * cam.horizontal[None, :]
         + v[:, None] * cam.vertical[None, :] - o)
    return o, d


def _assert_matches_brute(scene, o, d, t_min=1e-3, **kw):
    table = pallas_sweep.pack_prim_table(
        scene, kw.get("prim_tile", pallas_sweep.PRIM_TILE))
    pi, pt, pv = pallas_sweep.pallas_closest(table, o, d, t_min,
                                             interpret=True, **kw)
    bi, bt, bv = intersect.brute_force_closest(
        scene, o, d, jnp.float32(t_min), intersect.BIG_T)
    np.testing.assert_array_equal(np.asarray(pv), np.asarray(bv))
    m = np.asarray(bv)
    assert m.any()
    np.testing.assert_array_equal(np.asarray(pi)[m], np.asarray(bi)[m])
    np.testing.assert_allclose(np.asarray(pt)[m], np.asarray(bt)[m],
                               rtol=1e-5)
    assert pi.shape == pt.shape == pv.shape == (o.shape[0],)


@pytest.mark.parametrize("maker,n_rays", [
    (lambda: test_world(), 256),
    (lambda: get_world("triangle", total_count=80), 384),
])
def test_pallas_matches_tensor(maker, n_rays):
    """Same winners as the XLA dense sweep (t to f32 association order)."""
    scene, cam = maker()
    o, d = _rays(cam, n_rays)
    tables = tensor_sweep.pack_sweep_tables(scene, tile=1024)
    ti, tt, tv = tensor_sweep.tensor_closest(
        tables, o, d, jnp.float32(1e-3), intersect.BIG_T)
    table = pallas_sweep.pack_prim_table(scene)
    pi, pt, pv = pallas_sweep.pallas_closest(table, o, d, 1e-3,
                                             interpret=True)

    np.testing.assert_array_equal(np.asarray(tv), np.asarray(pv))
    m = np.asarray(tv)
    np.testing.assert_array_equal(np.asarray(ti)[m], np.asarray(pi)[m])
    np.testing.assert_allclose(np.asarray(pt)[m], np.asarray(tt)[m],
                               rtol=1e-5)


def test_ray_tile_divisor_fallback():
    """Wavefronts that are not a ray-block multiple are padded, not
    refused."""
    scene, cam = test_world()
    o, d = _rays(cam, 96)  # not a multiple of the 64-ray block
    table = pallas_sweep.pack_prim_table(scene)
    idx, t, valid = pallas_sweep.pallas_closest(table, o, d, 1e-3,
                                                interpret=True)
    assert idx.shape == (96,)


def _spheres(n, seed=0):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    m = b.add_lambertian((0.5, 0.5, 0.5))
    for c in rng.uniform(-4, 4, (n, 3)):
        b.add_sphere(tuple(c), float(rng.uniform(0.2, 0.8)), m)
    return b.build()


def _triangles(n, seed=0):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    m = b.add_lambertian((0.5, 0.5, 0.5))
    for c in rng.uniform(-4, 4, (n, 3)):
        e = rng.uniform(-1, 1, (2, 3))
        b.add_triangle(tuple(c), tuple(c + e[0]), tuple(c + e[1]), m)
    return b.build()


def _random_rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = jnp.asarray(rng.uniform(-6, 6, (n, 3)), jnp.float32)
    d = jnp.asarray(rng.standard_normal((n, 3)), jnp.float32)
    return o, d


@pytest.mark.parametrize("case", [
    "pad_rays",        # R = 100: padded to two 64-ray blocks
    "tile_remainder",  # N = 45: the last 32-prim tile is mostly padding
    "all_spheres",
    "all_triangles",
    "small_blocks",    # non-default power-of-two block sizes
])
def test_triton_kernel_cases(case):
    kw = {}
    if case == "pad_rays":
        scene, (o, d) = _spheres(10), _random_rays(100)
    elif case == "tile_remainder":
        scene, (o, d) = _triangles(45), _random_rays(128)
    elif case == "all_spheres":
        scene, (o, d) = _spheres(70), _random_rays(192)
    elif case == "all_triangles":
        scene, (o, d) = _triangles(70), _random_rays(192)
    else:
        scene, (o, d) = _triangles(40), _random_rays(64)
        kw = dict(ray_block=16, prim_tile=8)
    _assert_matches_brute(scene, o, d, **kw)


def test_prim_table_layout():
    """pack_prim_table: one row per field, prims along columns, padding
    to the tile as zero-edge triangles (always rejected: det == 0)."""
    scene, _ = get_world("triangle", total_count=40)
    table = np.asarray(pallas_sweep.pack_prim_table(scene, prim_tile=32))
    n = scene.num_prims
    assert table.shape == (11, -(-n // 32) * 32)
    np.testing.assert_array_equal(table[0:3, :n], np.asarray(scene.v0).T)
    np.testing.assert_array_equal(table[6:9, :n], np.asarray(scene.e2).T)
    np.testing.assert_array_equal(table[9, :n], np.asarray(scene.radius))
    assert not table[:, n:].any()


def test_pallas_render_matches_tensor(monkeypatch):
    """End to end through the renderer: accel="pallas" (interpret mode)
    gives the tensor path's image on the test world."""
    import functools

    from pathtracer_tpu.config import RenderConfig
    from pathtracer_tpu.render.renderer import render_image
    monkeypatch.setattr(pallas_sweep, "make_pallas_closest_hit",
                        functools.partial(
                            pallas_sweep.make_pallas_closest_hit,
                            interpret=True))
    scene, cam = test_world()
    cfg = RenderConfig(width=32, height=18, spp=2, max_depth=3,
                       ray_chunk=576, scene="test")
    a = np.asarray(render_image(scene, cam, cfg.replace(accel="pallas")))
    b = np.asarray(render_image(scene, cam, cfg.replace(accel="tensor")))
    np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.gpu
def test_compiled_kernel_matches_brute(gpu):
    """The kernel as compiled by Triton for the card, at a full 57,600-ray
    chunk, against the brute-force reference."""
    scene, cam = get_world("triangle")
    o, d = _rays(cam, 57600)
    table = pallas_sweep.pack_prim_table(scene)
    pi, pt, pv = jax.jit(
        lambda o, d: pallas_sweep.pallas_closest(table, o, d, 1e-3))(o, d)
    bi, bt, bv = intersect.brute_force_closest(
        scene, o, d, jnp.float32(1e-3), intersect.BIG_T)
    both = np.asarray(pv) & np.asarray(bv)
    flips = (np.mean(np.asarray(pv) != np.asarray(bv))
             + np.mean(np.asarray(pi)[both] != np.asarray(bi)[both]))
    assert flips <= 5e-5, flips
