"""Top-level renderer: pixel grid -> rays -> integrator -> gamma'd image.

Replaces the reference render megakernel driver (``main.cu:271-294`` +
``renderToPng``, ``main.cu:462-487``). Execution shape is a wavefront:

- the image is flattened to a ray wavefront and processed in fixed-size
  chunks (``lax.map`` serializes chunks, bounding HBM working set),
- the spp loop is a ``lax.fori_loop`` accumulating into a framebuffer —
  one compilation, no per-sample relaunch,
- RNG is stateless: sample s of pixel p at bounce b derives from
  fold(seed, s, chunk, b) + array position (replaces curand state arrays,
  main.cu:262-269).

Pixel conventions match the reference: u = (col + xi)/W, v = (row + xi)/H
with row 0 at the *bottom* of the image (the PNG writer flips rows,
main.cu:477-483); writeback is gamma-2 ``sqrt(c/spp)`` (main.cu:290-293).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from pathtracer_tpu import config as config_mod
from pathtracer_tpu.config import RenderConfig
from pathtracer_tpu.core import camera as camera_mod
from pathtracer_tpu.render import integrator
from pathtracer_tpu.scene.scene import Scene


def _pixel_grid(width: int, height: int):
    """(row, col) float arrays for the flattened framebuffer, row-major with
    curPixel = row * W + col (main.cu:275-280)."""
    rows = jnp.repeat(jnp.arange(height, dtype=jnp.float32), width)
    cols = jnp.tile(jnp.arange(width, dtype=jnp.float32), (height,))
    return rows, cols


def resolved_accel(cfg: RenderConfig) -> str:
    """The closest-hit structure ``cfg.accel`` resolves to here."""
    return config_mod.resolve_accel(cfg.accel)


def prepare_bvh(cfg: RenderConfig, scene: Scene, bvh=None):
    """The LBVH the render needs: ``bvh`` (built on device if missing) when
    the accel resolves to "bvh", else None."""
    if resolved_accel(cfg) != "bvh":
        return None
    if bvh is None:
        from pathtracer_tpu.accel.lbvh import build_lbvh
        bvh = build_lbvh(scene)
    return bvh


def _make_closest(scene: Scene, bvh, t_min: float, accel: str = None):
    """Pick the closest-hit query for the resolved accel: the dense sweep
    as XLA matmuls ("tensor") or as one Triton kernel ("pallas"), the LBVH
    traversal ("bvh"; the tree is built in-trace when ``bvh`` is None), or
    the linear scan ("brute", render_manager.h:71-84)."""
    accel = config_mod.resolve_accel(accel)
    if accel == "tensor":
        from pathtracer_tpu.ops.tensor_sweep import make_tensor_closest_hit
        return _with_shadow(make_tensor_closest_hit, scene, t_min)
    if accel == "pallas":
        from pathtracer_tpu.ops.pallas_sweep import make_pallas_closest_hit
        return _with_shadow(make_pallas_closest_hit, scene, t_min)
    if accel == "brute":
        return _with_shadow(integrator.make_brute_closest_hit, scene, t_min)
    from pathtracer_tpu.ops.traversal import make_bvh_closest_hit
    if bvh is None:
        from pathtracer_tpu.accel.lbvh import build_lbvh
        bvh = build_lbvh(scene)
    closest = make_bvh_closest_hit(scene, bvh, t_min)
    shadow = make_bvh_closest_hit(scene, bvh, config_mod.K_SHADOW_T_MIN)
    closest.query_shadow = shadow
    return closest


def _with_shadow(factory, scene: Scene, t_min: float):
    """Attach a near-zero-t_min NEE shadow query to a closest-hit fn.

    Shadow segments are unnormalized (light at t == 1): the accel's
    parametric t_min is a proportional ignore window, so shadow queries use
    K_SHADOW_T_MIN instead — self-intersection is prevented by the absolute
    origin offset in render/lights.direct_lighting (config.py rationale)."""
    closest = factory(scene, t_min)
    shadow = factory(scene, config_mod.K_SHADOW_T_MIN)
    closest.query_shadow = shadow
    return closest


def _stratum_grid(spp: int) -> int:
    """Largest m with m^2 dividing spp (uniform stratified pixel filter)."""
    m = max(1, int(spp ** 0.5))
    while m > 1 and spp % (m * m) != 0:
        m -= 1
    return m


def render_sum(scene: Scene, bvh, cam: camera_mod.Camera, base_key,
               rows, cols, cfg: RenderConfig, spp: int,
               sample_offset=0, differentiable: bool = False,
               with_stats: bool = False):
    """Radiance SUM over ``spp`` samples for a flat pixel wavefront.

    The shared core of the single-chip renderer, the sharded renderer
    (parallel/sharded.py) and the differentiable pass (render/diff.py):

    - ``rows``/``cols``: (P,) float32 pixel coordinates; P must be a multiple
      of ``cfg.ray_chunk`` (callers pre-pad). Chunks are serialized with
      ``lax.map`` to bound the HBM working set.
    - ``sample_offset``: global index of the first sample — spp-sharded
      callers pass their shard offset so every (pixel, sample) pair draws a
      unique stateless key regardless of the device layout.
    - chunk keys derive from the first pixel's *global* linear index, so a
      pixel's jitter sequence is invariant to how the wavefront is sharded
      across devices (determinism test: same seed => same image, SURVEY §5).

    Returns (P, 3) float32 — linear radiance, NOT averaged or gamma'd —
    or ((P, 3), executed_queries) when ``with_stats`` (the closest-hit
    query count the accel actually executed; see integrator.trace).
    """
    n_padded = rows.shape[0]
    chunk = min(cfg.ray_chunk, n_padded)
    n_chunks = n_padded // chunk
    assert n_chunks * chunk == n_padded, "wavefront must be chunk-aligned"
    rows_c = rows.reshape(n_chunks, chunk)
    cols_c = cols.reshape(n_chunks, chunk)
    w_inv = 1.0 / cfg.width
    h_inv = 1.0 / cfg.height

    closest = _make_closest(scene, bvh, cfg.t_min, cfg.accel)
    # stratification grid (cfg.stratify): sample s jitters inside stratum
    # (s mod m^2) of an m x m sub-pixel grid — same marginal distribution,
    # lower variance. m is the largest integer with m^2 | spp so every
    # stratum is visited exactly spp/m^2 times; a plain floor(sqrt(spp))
    # would oversample the first (spp mod m^2) strata — a systematic
    # spatial bias in the pixel filter, not just extra variance. m derives
    # from the configured total spp so sharded / checkpointed runs with
    # sample offsets stay consistent.
    m_strat = _stratum_grid(cfg.spp) if cfg.stratify else 1
    inv_m = 1.0 / m_strat
    use_sobol = getattr(cfg, "sampler", "random") == "sobol"

    def sample_pass(s, acc):
        s_global = sample_offset + s
        skey = jax.random.fold_in(base_key, s_global)
        stratum = jnp.mod(s_global, m_strat * m_strat)
        sx = jnp.mod(stratum, m_strat).astype(jnp.float32)
        sy = (stratum // m_strat).astype(jnp.float32)

        def render_chunk(args):
            row, col = args
            pix0 = (row[0] * cfg.width + col[0]).astype(jnp.int32)
            ckey = jax.random.fold_in(skey, pix0)
            pkey, tkey, lkey1, lkey2 = jax.random.split(ckey, 4)
            # pixel jitter (main.cu:284-285), optionally stratified or
            # Owen-scrambled Sobol (core/sampling.sobol_owen_2d)
            if use_sobol:
                from pathtracer_tpu.core.sampling import sobol_owen_2d
                pix_id = (row * cfg.width + col).astype(jnp.int32)
                x0, x1 = sobol_owen_2d(s_global.astype(jnp.uint32),
                                       pix_id, cfg.seed)
                xi = jnp.stack([x0, x1])
            else:
                xi = jax.random.uniform(pkey, (2, chunk), jnp.float32)
                if m_strat > 1:
                    xi = jnp.stack([(sx + xi[0]) * inv_m,
                                    (sy + xi[1]) * inv_m])
            u = (col + xi[0]) * w_inv
            v = (row + xi[1]) * h_inv
            u_disk = jax.random.uniform(lkey1, (2, chunk), jnp.float32)
            u_time = jax.random.uniform(lkey2, (chunk,), jnp.float32)
            o, d, t = camera_mod.get_rays(cam, u, v, u_disk[0], u_disk[1],
                                          u_time)
            out = integrator.trace(
                scene, o, d, t, tkey, cfg.max_depth, closest,
                t_min=cfg.t_min, sky=cfg.sky,
                terminate_black=cfg.terminate_black,
                differentiable=differentiable, nee=cfg.nee,
                with_stats=with_stats, rr=cfg.rr, rr_depth=cfg.rr_depth)
            return out if with_stats else (out, jnp.zeros((2,), jnp.float32))

        acc, n_exec = acc
        radiance, chunk_exec = jax.lax.map(render_chunk, (rows_c, cols_c))
        # executed-query counters ride f32: the whole-render sum exceeds
        # int32 at production scale (1920x1080 x 512spp x depth 50 ~ 5e10
        # nominal) — the accumulator trades exactness above 2^24 for ~1e-7
        # relative error (a throughput statistic, not a checksum). Shape
        # (2,): [closest_hit, shadow] (integrator.trace).
        return (acc + radiance.reshape(n_padded, 3),
                n_exec + jnp.sum(chunk_exec, axis=0))

    acc, n_exec = jax.lax.fori_loop(
        0, spp, sample_pass,
        (jnp.zeros((n_padded, 3), jnp.float32), jnp.zeros((2,), jnp.float32)))
    return (acc, n_exec) if with_stats else acc


def padded_pixel_grid(cfg: RenderConfig, multiple: int):
    """(rows, cols) flat f32 grids padded to a multiple of ``multiple``."""
    rows, cols = _pixel_grid(cfg.width, cfg.height)
    n_pixels = cfg.num_pixels
    n_padded = -(-n_pixels // multiple) * multiple
    return (jnp.pad(rows, (0, n_padded - n_pixels)),
            jnp.pad(cols, (0, n_padded - n_pixels)))


def make_renderer(cfg: RenderConfig, with_bvh: bool,
                  with_stats: bool = False):
    """Build a jitted ``render(scene, bvh, camera, seed) -> (H, W, 3)``
    (or ``-> ((H, W, 3), executed_queries)`` when ``with_stats``).

    ``bvh`` must be None iff ``with_bvh`` is False (two cached variants).
    """
    n_pixels = cfg.num_pixels
    chunk = min(cfg.ray_chunk, n_pixels)
    rows0, cols0 = padded_pixel_grid(cfg, chunk)

    def render(scene: Scene, bvh, cam: camera_mod.Camera, seed):
        base_key = jax.random.PRNGKey(seed)
        acc = render_sum(scene, bvh, cam, base_key, rows0, cols0, cfg,
                         cfg.spp, with_stats=with_stats)
        if with_stats:
            acc, n_exec = acc
        # gamma-2 writeback (main.cu:290-293)
        img = jnp.sqrt(jnp.maximum(acc[:n_pixels], 0.0) / cfg.spp)
        img = img.reshape(cfg.height, cfg.width, 3)
        return (img, n_exec) if with_stats else img

    return jax.jit(render)


def _experiment_env_sig() -> tuple:
    """The PT_* experiment knobs are read at *trace* time (the documented
    env-gated A/B pattern), so they must participate in the renderer cache
    key — otherwise an in-process toggle after a same-cfg render silently
    hits the stale jitted renderer and no-ops."""
    import os
    return tuple(sorted((k, v) for k, v in os.environ.items()
                        if k.startswith(("PT_SWEEP_", "PT_RNG_"))))


@functools.lru_cache(maxsize=16)
def _cached_renderer(cfg: RenderConfig, with_bvh: bool, env_sig: tuple = ()):
    return make_renderer(cfg, with_bvh)


def render_image(scene: Scene, cam: camera_mod.Camera, cfg: RenderConfig,
                 seed: Optional[int] = None, bvh=None) -> jnp.ndarray:
    """Render with cfg.accel, returning (H, W, 3) f32 in scanline order
    row 0 = bottom (flip at save, like main.cu:477-483).

    When the accel resolves to "bvh" and no prebuilt ``bvh`` is passed, the
    LBVH is built on device first (one-time per scene; reference builds at
    scene upload, main.cu:194-195).
    """
    bvh = prepare_bvh(cfg, scene, bvh)
    render = _cached_renderer(cfg, bvh is not None, _experiment_env_sig())
    return render(scene, bvh, cam, cfg.seed if seed is None else seed)
