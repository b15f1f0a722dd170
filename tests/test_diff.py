"""Differentiable-pass tests: gradients vs finite differences (the BASELINE
gradient-correctness requirement) and a small inverse-rendering fit."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pathtracer_tpu.config import RenderConfig
from pathtracer_tpu.core.camera import make_camera
from pathtracer_tpu.render import diff
from pathtracer_tpu.render import renderer as renderer_mod
from pathtracer_tpu.scene.scene import SceneBuilder

CFG = RenderConfig(width=8, height=8, spp=2, max_depth=3, accel="brute",
                   ray_chunk=64, scene="test", sky=True)


def _sphere_scene(emissive=False):
    b = SceneBuilder()
    m = b.add_lambertian((0.6, 0.3, 0.2))
    b.add_sphere((0, 0, -3), 1.0, m)
    if emissive:
        e = b.add_emissive((4.0, 3.0, 2.0))
        b.add_sphere((0, 2.2, -3), 0.7, e)
    cam = make_camera((0, 0, 1), (0, 0, -3), 60, 1.0, aperture=0,
                      focus_dist=4, time0=0.0, time1=0.0)
    return b.build(), cam


def _loss_builder(scene, cam, fields):
    rows, cols = renderer_mod.padded_pixel_grid(CFG, 64)
    key = jax.random.PRNGKey(0)
    target = jnp.zeros((rows.shape[0], 3), jnp.float32)

    def loss(params):
        s = diff.apply_params(scene, params)
        img = diff.render_linear(s, None, cam, key, rows, cols, CFG, CFG.spp)
        return jnp.mean((img - target) ** 2)

    return loss, diff.scene_params(scene, fields)


@pytest.mark.parametrize("emissive,field,index", [
    (False, "albedo", (0, 0)),
    (False, "albedo", (0, 2)),
    (True, "emit", (1, 1)),
])
def test_grad_matches_finite_difference(emissive, field, index):
    """d(loss)/d(albedo|emission) == central finite difference: the RNG is
    stateless, so the loss is a deterministic, a.e.-smooth function of the
    shading parameters (visibility is detached by construction)."""
    scene, cam = _sphere_scene(emissive)
    loss, params = _loss_builder(scene, cam, ("albedo", "emit"))
    g = jax.grad(loss)(params)[field][index]

    eps = 1e-2
    def perturbed(sign):
        p = dict(params)
        p[field] = p[field].at[index].add(sign * eps)
        return loss(p)
    fd = (perturbed(+1.0) - perturbed(-1.0)) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=5e-3, atol=1e-6)


def test_vertex_gradient_flows():
    """Geometry gradients: moving the sphere center changes the image
    through the differentiable hit re-evaluation (detached visibility), and
    the AD gradient tracks central finite differences (the FD signal also
    includes silhouette-visibility shifts the detached estimator ignores, so
    the tolerance is loose)."""
    scene, cam = _sphere_scene()
    loss, params = _loss_builder(scene, cam, ("v0",))
    g = np.asarray(jax.grad(loss)(params)["v0"])
    assert np.all(np.isfinite(g))
    assert np.abs(g).sum() > 0.0

    eps = 1e-3
    for axis in (0, 1):
        def perturbed(sign):
            p = {"v0": params["v0"].at[0, axis].add(sign * eps)}
            return float(loss(p))
        fd = (perturbed(+1.0) - perturbed(-1.0)) / (2 * eps)
        np.testing.assert_allclose(g[0, axis], fd, rtol=0.05, atol=1e-4)


def test_train_step_and_fit_reduce_loss():
    """Inverse rendering: recover a brighter albedo from a target rendered
    with it (SURVEY §7 step 6 validation)."""
    scene, cam = _sphere_scene()
    rows, cols = renderer_mod.padded_pixel_grid(CFG, 64)
    key = jax.random.PRNGKey(0)
    target_scene = scene._replace(
        albedo=jnp.array([[0.9, 0.1, 0.5]], jnp.float32))
    target = diff.render_linear(target_scene, None, cam, key, rows, cols,
                                CFG, CFG.spp)

    # frozen noise realization (seed matches the target render): the
    # objective is deterministic with an exact global minimum at the target
    # albedo, so the loss must drop hard.
    params, history = diff.fit(scene, None, cam, target[:CFG.num_pixels],
                               CFG, steps=40, lr=0.05, seed=0,
                               resample=False)
    assert history[-1] < history[0] * 0.1, history
    got = np.asarray(params["albedo"][0])
    assert abs(got[0] - 0.9) < 0.1, got
    assert abs(got[2] - 0.5) < 0.1, got


def test_sharded_train_step_matches_single():
    """The mesh-sharded step (psum grad all-reduce) computes the same loss
    and the same updated params as the single-chip step."""
    from pathtracer_tpu.parallel.mesh import make_mesh
    scene, cam = _sphere_scene()
    rows, cols = renderer_mod.padded_pixel_grid(CFG, 64)
    target = jnp.zeros((CFG.num_pixels, 3), jnp.float32)
    optimizer = optax.sgd(0.1)
    params = diff.scene_params(scene)

    step1 = diff.make_train_step(CFG, optimizer)
    p1, _, l1 = step1(params, optimizer.init(params), scene, None, cam,
                      target, 5)

    # rays=8 x spp=1: per-device shard = 8 pixels, chunk 8 != single-chip
    # chunk 64 -> different jitter draws; use a chunk-matching mesh (1 ray
    # shard) to compare numerics exactly.
    mesh = make_mesh(jax.devices()[:1], spp_axis_size=1)
    step8 = diff.make_train_step(CFG, optimizer, mesh=mesh)
    p8, _, l8 = step8(params, optimizer.init(params), scene, None, cam,
                      target, 5)
    np.testing.assert_allclose(float(l1), float(l8), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(p1["albedo"]),
                               np.asarray(p8["albedo"]), atol=1e-6)

    # and an actually-sharded step must agree on the loss value to MC
    # tolerance when chunk layout matches: 64 pixels / 8 devices with
    # ray_chunk=8 on both sides.
    cfg8 = CFG.replace(ray_chunk=8)
    mesh8 = make_mesh(jax.devices()[:8], spp_axis_size=1)
    s1 = diff.make_train_step(cfg8, optimizer)
    s8 = diff.make_train_step(cfg8, optimizer, mesh=mesh8)
    pa, _, la = s1(params, optimizer.init(params), scene, None, cam, target,
                   5)
    pb, _, lb = s8(params, optimizer.init(params), scene, None, cam, target,
                   5)
    np.testing.assert_allclose(float(la), float(lb), rtol=1e-5)
    # the gradient is all-reduced: every pixel's contribution, not just
    # the shard that owns the returned replica
    np.testing.assert_allclose(np.asarray(pa["albedo"]),
                               np.asarray(pb["albedo"]), atol=1e-6)


def test_dryrun_multichip():
    """The driver's multi-chip dry run: full sharded training step on an
    8-device mesh."""
    import __graft_entry__ as graft
    graft.dryrun_multichip(8)
