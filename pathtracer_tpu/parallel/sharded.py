"""shard_map-sharded rendering over the (rays, spp) mesh.

The multi-device replacement for the reference's single-GPU pixel grid
(``main.cu:271-294``): the flattened framebuffer is sharded across the
``rays`` mesh axis, samples across the ``spp`` axis; each device runs the same
wavefront core (render/renderer.render_sum) on its shard; one ``psum`` over
the spp axis accumulates sample sums. Scene, BVH and camera ride in
replicated (one-time broadcast — the device_put analogue of the reference's
cudaMemcpy scene upload, main.cu:176-195).

Per-(pixel, sample) RNG keys are global — derived from the pixel chunk's
first global linear index and the global sample index — so every (pixel,
sample) radiance is a pure function of (seed, chunk layout), independent of
which device computed it. With the same ``ray_chunk`` the sharded and
single-device renders agree to fp-summation-order tolerance; the same seed on
the same mesh is bit-identical (determinism requirement, SURVEY §5).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pathtracer_tpu.config import RenderConfig
from pathtracer_tpu.core import camera as camera_mod
from pathtracer_tpu.render import renderer as renderer_mod
from pathtracer_tpu.scene.scene import Scene

from pathtracer_tpu.parallel.mesh import RAYS_AXIS, SPP_AXIS


# Minimum chunks per device for the round-robin interleave. Contiguous
# raster sharding load-imbalances badly — sky shards terminate in one
# bounce while geometry shards trace full paths (executed-query counts per
# shard, mean/max 0.73 on the bunny frame over 8 shards); striding chunks
# across the frame gives every device a cross-section of the scene (0.97+).
# More chunks = finer balance but more lax.map steps per device.
K_INTERLEAVE = 4


def _shard_plan(cfg: RenderConfig, mesh: Mesh):
    """Static layout: per-device pixel count (chunk-aligned) and spp split."""
    rays_size = mesh.shape[RAYS_AXIS]
    spp_size = mesh.shape[SPP_AXIS]
    if cfg.spp % spp_size != 0:
        raise ValueError(f"spp={cfg.spp} not divisible by spp axis "
                         f"size {spp_size}")
    spp_local = cfg.spp // spp_size
    n_pixels = cfg.num_pixels
    # Each device's shard must be a whole number of chunks; aim for at
    # least K_INTERLEAVE chunks per device so the round-robin assignment
    # can balance (keep chunks >= 1024 rays so tiny frames don't shatter).
    chunk = min(cfg.ray_chunk, -(-n_pixels // rays_size))
    target = -(-n_pixels // (rays_size * K_INTERLEAVE))
    if chunk > max(target, 1024):
        chunk = max(target, 1024)
    per_dev = -(-n_pixels // (rays_size * chunk)) * chunk
    return rays_size, spp_size, spp_local, per_dev, chunk


def make_sharded_renderer(cfg: RenderConfig, mesh: Mesh,
                          with_bvh: bool = True):
    """Build a jitted ``render(scene, bvh, cam, seed) -> (H, W, 3)`` that
    runs sharded over ``mesh``. Output is fully replicated (every process
    can save its addressable copy — multi-host framebuffer assembly)."""
    rays_size, spp_size, spp_local, per_dev, chunk = _shard_plan(cfg, mesh)
    n_padded = per_dev * rays_size
    rows0, cols0 = renderer_mod.padded_pixel_grid(cfg, n_padded)
    cfg_local = cfg.replace(ray_chunk=chunk)

    # Round-robin chunk interleave: device d renders chunks d, d+R,
    # d+2R, ... so every device sees a cross-section of the frame instead
    # of a contiguous raster band (load balance, see K_INTERLEAVE). Each
    # chunk itself is untouched — its RNG keys derive from its first
    # pixel's GLOBAL index, so every (pixel, sample) radiance is
    # unchanged; only which device computes it moves. The inverse
    # permutation restores raster order after the all_gather.
    n_chunks_total = n_padded // chunk
    per_dev_chunks = per_dev // chunk
    perm = jnp.arange(n_chunks_total).reshape(
        per_dev_chunks, rays_size).T.reshape(-1)
    rows0 = rows0.reshape(n_chunks_total, chunk)[perm].reshape(-1)
    cols0 = cols0.reshape(n_chunks_total, chunk)[perm].reshape(-1)

    repl = P()
    shard_rays = P(RAYS_AXIS)

    def device_fn(scene, bvh, cam, seed, rows, cols):
        # global sample offset of this device's spp shard
        spp_idx = jax.lax.axis_index(SPP_AXIS)
        base_key = jax.random.PRNGKey(seed[0])
        acc = renderer_mod.render_sum(
            scene, bvh, cam, base_key, rows, cols, cfg_local, spp_local,
            sample_offset=spp_idx * spp_local)
        # combine sample sums across the spp axis (all-reduce)
        acc = jax.lax.psum(acc, SPP_AXIS)
        # assemble the replicated framebuffer across the rays axis
        return jax.lax.all_gather(acc, RAYS_AXIS, axis=0, tiled=True)

    # check_vma=False: the wavefront core's loop carries (bounce scan, spp
    # fori, traversal while) start from literal zeros, which the varying-
    # manual-axes checker rejects even though every lane is device-local.
    sharded = jax.shard_map(
        device_fn, mesh=mesh,
        in_specs=(repl, repl, repl, repl, shard_rays, shard_rays),
        out_specs=repl, check_vma=False)

    def render(scene: Scene, bvh, cam: camera_mod.Camera, seed):
        seed_arr = jnp.atleast_1d(jnp.asarray(seed, jnp.int32))
        acc = sharded(scene, bvh, cam, seed_arr, rows0, cols0)
        # undo the round-robin interleave (device-major chunk order ->
        # raster chunk order); a device-local reshape of the replicated
        # output, no collective
        acc = acc.reshape(rays_size, per_dev_chunks, chunk, 3).transpose(
            1, 0, 2, 3).reshape(n_padded, 3)
        img = jnp.sqrt(jnp.maximum(acc[:cfg.num_pixels], 0.0) / cfg.spp)
        return img.reshape(cfg.height, cfg.width, 3)

    return jax.jit(render)


@functools.lru_cache(maxsize=8)
def _cached_sharded(cfg: RenderConfig, mesh: Mesh, with_bvh: bool):
    return make_sharded_renderer(cfg, mesh, with_bvh)


def sharded_render_image(scene: Scene, cam, cfg: RenderConfig, mesh: Mesh,
                         bvh=None):
    """Render ``cfg`` over ``mesh``; builds the LBVH on device if needed."""
    bvh = renderer_mod.prepare_bvh(cfg, scene, bvh)
    render = _cached_sharded(cfg, mesh, bvh is not None)
    return render(scene, bvh, cam, cfg.seed)
