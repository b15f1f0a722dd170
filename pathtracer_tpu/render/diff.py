"""Differentiable rendering + inverse-rendering training step.

SURVEY §7 step 6: the shading/accumulation path is pure JAX and
differentiable; visibility (which primitive wins the closest-hit query) is
discrete and detached — the traversal's integer output gets no cotangent, and
the hit geometry is re-evaluated in closed form so gradients flow to vertices,
centers, albedos and emission (ops/intersect.hit_records_from_prims).

Trainable parameters are a dict of Scene array fields (default: albedo +
emission; add "v0" for vertex/center translation gradients). The train step
is a jitted value_and_grad + optax update; over a mesh it runs under
shard_map with pixels sharded on the ``rays`` axis and a ``psum`` gradient
all-reduce — the reference has no analogue (single GPU, no training), this is
the BASELINE "gradient all-reduce overlapped with backward sweep" component.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from pathtracer_tpu.config import RenderConfig
from pathtracer_tpu.parallel.mesh import RAYS_AXIS, SPP_AXIS
from pathtracer_tpu.render import renderer as renderer_mod
from pathtracer_tpu.scene.scene import Scene

DEFAULT_PARAM_FIELDS = ("albedo", "emit")


def scene_params(scene: Scene, fields=DEFAULT_PARAM_FIELDS) -> Dict:
    """Extract the trainable parameter dict from a scene."""
    return {f: getattr(scene, f) for f in fields}


def apply_params(scene: Scene, params: Dict) -> Scene:
    """Rebind parameter arrays into the scene pytree."""
    return scene._replace(**params)


def render_linear(scene: Scene, bvh, cam, key, rows, cols,
                  cfg: RenderConfig, spp: int, sample_offset=0):
    """Mean linear radiance per pixel, (P, 3) — the differentiable forward
    (pre-gamma; gamma's sqrt has an unbounded derivative at 0, so losses are
    taken in linear space)."""
    acc = renderer_mod.render_sum(scene, bvh, cam, key, rows, cols, cfg,
                                  spp, sample_offset, differentiable=True)
    return acc / spp


def _loss_local(params, scene, bvh, cam, key, rows, cols, target, weight,
                cfg, spp, sample_offset=0):
    """Local SSE + weighted pixel count on this shard. ``weight`` is (P,)
    with 0 on wavefront-padding rows so they cannot pollute the objective."""
    img = render_linear(apply_params(scene, params), bvh, cam, key,
                        rows, cols, cfg, spp, sample_offset)
    err = img - target
    sse = jnp.sum(weight[:, None] * err * err)
    return sse, jnp.sum(weight) * 3.0


def make_train_step(cfg: RenderConfig,
                    optimizer: optax.GradientTransformation,
                    mesh: Optional[Mesh] = None,
                    spp: Optional[int] = None):
    """Build a jitted inverse-rendering step.

    ``step(params, opt_state, scene, bvh, cam, target, seed)
        -> (params, opt_state, loss)``

    ``target`` is the (H*W or padded, 3) linear-radiance target image
    (flattened, same pixel order as renderer output). With a ``mesh``,
    pixels shard over the rays axis, samples over the spp axis, and the
    gradient/loss reduce with ``psum`` over both axes.
    """
    spp = cfg.spp if spp is None else spp

    if mesh is None:
        chunk = min(cfg.ray_chunk, cfg.num_pixels)
        rows0, cols0 = renderer_mod.padded_pixel_grid(cfg, chunk)
        n_padded = rows0.shape[0]
        weight0 = _pixel_weights(cfg.num_pixels, n_padded)
        cfg_local = cfg.replace(ray_chunk=chunk)

        def loss_fn(params, scene, bvh, cam, key, target):
            sse, n = _loss_local(params, scene, bvh, cam, key, rows0, cols0,
                                 target, weight0, cfg_local, spp)
            return sse / n

        def step(params, opt_state, scene, bvh, cam, target, seed):
            target = _pad_target(target, n_padded)
            key = jax.random.PRNGKey(seed)
            loss, grads = jax.value_and_grad(loss_fn)(
                params, scene, bvh, cam, key, target)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        return jax.jit(step)

    # --- mesh-sharded step ---
    from pathtracer_tpu.parallel.sharded import _shard_plan
    rays_size, spp_size, spp_local, per_dev, chunk = _shard_plan(
        cfg.replace(spp=spp), mesh)
    n_padded = per_dev * rays_size
    rows0, cols0 = renderer_mod.padded_pixel_grid(cfg, n_padded)
    weight0 = _pixel_weights(cfg.num_pixels, n_padded)
    cfg_local = cfg.replace(ray_chunk=chunk)

    repl = P()
    shard_rays = P(RAYS_AXIS)

    def device_step(params, opt_state, scene, bvh, cam, target, seed, rows,
                    cols, w):
        key = jax.random.PRNGKey(seed[0])
        spp_idx = jax.lax.axis_index(SPP_AXIS)
        # NOTE: with spp_size > 1 each spp-shard evaluates MSE of its own
        # spp_local-sample estimate (a slightly higher-variance objective
        # than full-spp MSE); with spp_size == 1 this is exactly the full
        # objective. The loss is sum(sse) / sum(n) over both axes, so its
        # gradient is the all-reduced sum of the local SSE gradients over
        # the global pixel count.
        (sse, n), grads = jax.value_and_grad(_loss_local, has_aux=True)(
            params, scene, bvh, cam, key, rows, cols, target, w, cfg_local,
            spp_local, sample_offset=spp_idx * spp_local)
        axes = (RAYS_AXIS, SPP_AXIS)
        n = jax.lax.psum(n, axes)
        loss = jax.lax.psum(sse, axes) / n
        grads = jax.tree_util.tree_map(lambda g: jax.lax.psum(g, axes) / n,
                                       grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    sharded_step = jax.shard_map(
        device_step, mesh=mesh,
        in_specs=(repl, repl, repl, repl, repl, shard_rays, repl,
                  shard_rays, shard_rays, shard_rays),
        out_specs=(repl, repl, repl),
        check_vma=False)

    def step(params, opt_state, scene, bvh, cam, target, seed):
        target = _pad_target(target, n_padded)
        seed_arr = jnp.atleast_1d(jnp.asarray(seed, jnp.int32))
        return sharded_step(params, opt_state, scene, bvh, cam, target,
                            seed_arr, rows0, cols0, weight0)

    return jax.jit(step)


def _pixel_weights(n_pixels: int, n_padded: int):
    w = jnp.zeros(n_padded, jnp.float32)
    return w.at[:n_pixels].set(1.0)


def _pad_target(target, n_padded):
    target = target.reshape(-1, 3)
    pad = n_padded - target.shape[0]
    if pad > 0:
        target = jnp.pad(target, ((0, pad), (0, 0)))
    return target


def fit(scene: Scene, bvh, cam, target_img, cfg: RenderConfig,
        steps: int = 50, lr: float = 0.05, mesh: Optional[Mesh] = None,
        param_fields=DEFAULT_PARAM_FIELDS, spp: Optional[int] = None,
        seed: int = 0, resample: bool = True) -> Tuple[Dict, list]:
    """Small inverse-rendering fit loop (SURVEY §7 step 6 validation).

    Returns (fitted params, loss history). ``target_img`` is (H, W, 3)
    linear radiance. ``resample=True`` draws fresh sample jitter each step
    (SGD on the true expectation); ``resample=False`` freezes one noise
    realization — a deterministic objective whose minimum is exact when the
    target was rendered with the same (seed, spp).
    """
    optimizer = optax.adam(lr)
    step = make_train_step(cfg, optimizer, mesh=mesh, spp=spp)
    params = scene_params(scene, param_fields)
    opt_state = optimizer.init(params)
    target = jnp.asarray(target_img, jnp.float32).reshape(-1, 3)
    history = []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, scene, bvh, cam,
                                       target, seed + i if resample else seed)
        history.append(float(loss))
    return params, history
