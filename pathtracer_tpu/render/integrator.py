"""Wavefront path integrator.

The reference's per-thread bounce loop (``main.cu:21-37``) becomes a
``lax.scan`` over bounce depth carrying a whole wavefront of rays — the
megakernel-free design SURVEY §7 calls for. Per bounce: one closest-hit
query (BVH or brute), one dense masked scatter, mask updates. Exit semantics
replicate the reference exactly:

- miss         -> sky(last direction) * attenuation   (main.cu:27-36)
- absorbed     -> black                               (main.cu:30-31)
- depth out    -> sky(last direction) * attenuation   (the reference quirk,
                  main.cu:26-36; ``terminate_black`` flips this to black)
- emissive hit -> accumulated emitted * attenuation (extension; no sky term)

Visibility (which primitive a ray hits) is detached; the hit geometry and
shading are differentiable — see ops/intersect.hit_records_from_prims.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from pathtracer_tpu.core import vec
from pathtracer_tpu.ops import intersect
from pathtracer_tpu.scene import materials
from pathtracer_tpu.scene.scene import Scene

SKY_WHITE = jnp.array([1.0, 1.0, 1.0], jnp.float32)
SKY_BLUE = jnp.array([0.5, 0.7, 1.0], jnp.float32)

# Russian-roulette constants the reference ships but never uses
# (global_variables.h:39-41)
K_RR_CONTINUE = 0.8
K_RR_INV_CONTINUE = 1.25


def sky_color(direction):
    """Vertical white->blue gradient on unit direction (main.cu:34-36)."""
    unit = vec.normalize(direction)
    t = 0.5 * (unit[..., 1] + 1.0)
    return (1.0 - t)[..., None] * SKY_WHITE + t[..., None] * SKY_BLUE


def _uniform_by_ray(k, rid, m: int):
    """(R, m) uniforms keyed by *ray id*, not lane position, so every ray
    has a deterministic stream independent of where it sits in the
    wavefront (cross-accel image tests rely on this)."""
    import os
    if os.environ.get("PT_RNG_HASH") == "1":
        # Fast path: a keyed double-fmix32 counter hash, replacing the 20
        # threefry rounds per draw. The reference's own generator is curand XORWOW
        # (main.cu:262-269), a *weaker* class than murmur-grade mixing,
        # so a counter hash is quality-appropriate for this workload.
        # (rid << 3) | draw is injective (rid < 2^29, m <= 8); two keyed
        # fmix32 rounds (murmur3's
        # full-avalanche finalizer) decorrelate the counter lattice.
        # Draws stay a pure function of ray id — different stream, same
        # estimator
        # (test_hash_rng_unbiased).
        assert m <= 8, f"(rid << 3) | ctr is injective only for m <= 8, got {m}"
        kd = k if k.dtype == jnp.uint32 else jax.random.key_data(k)
        kd = kd.reshape(-1)
        ctr = jnp.arange(m, dtype=jnp.uint32)[None, :]
        x = (rid.astype(jnp.uint32)[:, None] << 3) | ctr
        x = x ^ kd[0]

        def fmix(v):
            v = v ^ (v >> 16)
            v = v * jnp.uint32(0x85EBCA6B)
            v = v ^ (v >> 13)
            v = v * jnp.uint32(0xC2B2AE35)
            return v ^ (v >> 16)

        x = fmix(fmix(x) + kd[1])
        f = jax.lax.bitcast_convert_type(
            (x >> jnp.uint32(9)) | jnp.uint32(0x3F800000), jnp.float32)
        return f - 1.0
    if os.environ.get("PT_RNG_FAST") == "1":
        # Legitimate fast path: ONE threefry sweep over per-ray blocks
        # (rid, column-block) replaces the per-ray fold_in sweep (a full
        # threefry block per ray) + the uniform sweep — fewer threefry
        # blocks (3 vs 4 for m=6), no serial fold_in->uniform chain, no
        # vmap. The primitive is bound directly because the high-level
        # threefry_2x32 pairs element i with element i+n/2 (output would
        # depend on lane layout); one block per (rid, j) keeps draws a
        # pure function of ray id and
        # collision-free per key. A different stream than the default,
        # the same estimator (test_integrator pins the mean).
        from jax.extend import random as jxr
        kd = k if k.dtype == jnp.uint32 else jax.random.key_data(k)
        kd = kd.reshape(-1)
        n_blk = (m + 1) // 2
        shape = (rid.shape[0], n_blk)
        x0 = jnp.broadcast_to(rid[:, None].astype(jnp.uint32), shape)
        x1 = jnp.broadcast_to(
            jnp.arange(n_blk, dtype=jnp.uint32)[None, :], shape)
        w0, w1 = jxr.threefry2x32_p.bind(kd[0], kd[1], x0, x1)
        bits = jnp.stack([w0, w1], axis=-1).reshape(
            rid.shape[0], 2 * n_blk)[:, :m]
        # bits -> [0, 1): the standard set-exponent trick (bitcast
        # 1.mantissa, subtract 1) — same construction jax.random.uniform
        # uses
        f = jax.lax.bitcast_convert_type(
            (bits >> jnp.uint32(9)) | jnp.uint32(0x3F800000), jnp.float32)
        return f - 1.0
    keys = jax.vmap(lambda r: jax.random.fold_in(k, r))(rid)
    return jax.vmap(lambda kk: jax.random.uniform(kk, (m,)))(keys)


# Type of a closest-hit query: (o, d, t_min) -> (idx, valid)
ClosestHitFn = Callable


def make_brute_closest_hit(scene: Scene, t_min: float):
    """Closest hit via linear scan (render_manager.h:71-84 equivalent)."""
    def closest(o, d):
        return intersect.brute_force_closest(
            scene, o, d, jnp.float32(t_min), intersect.BIG_T)
    return closest


def trace(scene: Scene,
          origin, direction, time,
          key,
          max_depth: int,
          closest_hit_fn,
          t_min: float = 1e-3,
          sky: bool = True,
          terminate_black: bool = False,
          differentiable: bool = False,
          nee: bool = False,
          with_stats: bool = False,
          rr: bool = False,
          rr_depth: int = 3):
    """Trace a wavefront of rays to radiance. Returns (N, 3), or
    ((N, 3), executed_queries) when ``with_stats`` — a (2,) f32 vector
    [closest_hit_queries, shadow_queries]: the lanes queried on the
    bounces that ran (the early exit below skips whole bounces once every
    ray has terminated; every accel queries all lanes of a bounce that
    runs), split so NEE shadow rays can never inflate the closest-hit
    Mrays/s. f32: per-trace query counts stay below 2^24 (exact).

    ``closest_hit_fn(o, d) -> (prim_idx, t, valid)`` is the pluggable
    acceleration structure (tensor / Pallas / BVH / brute). Its discrete
    output is detached; geometry is re-evaluated differentiably.

    ``differentiable=False`` runs the bounce loop as a ``lax.while_loop``
    that exits as soon as every ray has terminated — with the reference's
    depth-50 default most wavefronts die in a handful of bounces, so this
    skips the dead tail entirely (the wavefront answer to the reference's
    per-thread early ``break``, main.cu:27-31). Results are bit-identical to
    the scan: extra iterations are no-ops once ``alive`` is all-False.
    ``differentiable=True`` uses a fixed-trip ``lax.scan`` (reverse-mode AD
    cannot cross a while_loop).

    ``rr=True``: Russian-roulette path termination after ``rr_depth``
    bounces with the reference's (shipped but unused) constants — continue
    probability 0.8, survivor attenuation x1.25
    (global_variables.h:38-41). Unbiased; with depth-50 defaults it retires
    deep paths ~5x sooner at slightly higher variance per sample.

    ``nee=True`` (scenes with emissive lights): every diffuse bounce also
    samples one point on one light and casts a shadow ray (render/lights.py);
    the light sample and the BSDF-sampled emissive hit are combined with
    one-sample balance-heuristic MIS (camera rays and post-specular paths
    keep full emissive weight). The reference needs none of this — its only
    light is the sky.
    """
    n_rays = origin.shape[0]
    use_nee = bool(nee) and scene.num_lights > 0
    if use_nee:
        from pathtracer_tpu.render import lights as lights_mod
    # Lean bounce RNG (PT_RNG_LEAN=1): the three scatter lobes are mutually
    # exclusive per ray (a hit is lambertian OR metal OR dielectric), so
    # three fresh uniforms per bounce serve all six scatter columns —
    # lambertian reads (u0, u1), metal (u0, u1, u2), dielectric u2 — with
    # no intra-ray reuse of a consumed value. Images change (different
    # stream) but the estimator is unchanged; test_integrator pins the
    # mean. Saves a third of the per-bounce threefry work.
    import os as _os
    lean_rng = _os.environ.get("PT_RNG_LEAN") == "1"

    # ray ids key the per-ray draws (_uniform_by_ray)
    rid = jnp.arange(n_rays, dtype=jnp.int32)

    def bounce_step(depth, carry):
        (o, d, atten, alive, absorbed, emitted_acc, spec_prev, prev_pdf,
         n_exec) = carry
        bkey = jax.random.fold_in(key, depth)

        n_exec = n_exec.at[0].add(jnp.float32(n_rays))
        # Visibility query on detached geometry (discrete winner index).
        idx, _, hit_valid = closest_hit_fn(jax.lax.stop_gradient(o),
                                           jax.lax.stop_gradient(d))
        if lean_rng:
            u3 = _uniform_by_ray(bkey, rid, 3)
            uniforms = jnp.stack([u3[:, 0], u3[:, 1], u3[:, 0], u3[:, 1],
                                  u3[:, 2], u3[:, 2]], axis=1)
        else:
            uniforms = _uniform_by_ray(bkey, rid, 6)
        rec = intersect.hit_records_from_prims(
            scene, idx, o, d, jnp.float32(t_min), intersect.BIG_T, hit_valid)

        sc = materials.scatter(scene, rec, d, uniforms)

        active = alive & hit_valid
        # emissive termination: add radiance, stop, no sky contribution.
        # Under NEE+MIS, diffuse-sampled emissive hits carry the balance-
        # heuristic weight (the light sample carries the complement); camera
        # rays and post-specular paths keep full weight.
        hit_emitter = active & sc.is_emissive
        if use_nee:
            w_bsdf = lights_mod.bsdf_hit_light_weight(scene, rec, d,
                                                      prev_pdf)
            emit_w = jnp.where(spec_prev, 1.0, w_bsdf)
        else:
            emit_w = jnp.ones((n_rays,), jnp.float32)
        emitted_acc = emitted_acc + jnp.where(
            hit_emitter[:, None], atten * sc.emitted * emit_w[:, None], 0.0)
        # metal absorbed -> black (main.cu:30-31)
        newly_absorbed = active & ~sc.is_emissive & ~sc.ok
        absorbed = absorbed | newly_absorbed | hit_emitter

        step = active & sc.ok & ~sc.is_emissive

        if rr:
            # kill is decided for the *continuation*; this bounce's own
            # contributions (emission, NEE direct light) keep full weight
            u_rr = _uniform_by_ray(jax.random.fold_in(bkey, 2), rid,
                                   1)[:, 0]
            roulette = depth >= rr_depth
            killed = step & roulette & (u_rr >= K_RR_CONTINUE)
            survived_scale = jnp.where(step & roulette & ~killed,
                                       K_RR_INV_CONTINUE, 1.0)
        else:
            killed = jnp.zeros((n_rays,), bool)
            survived_scale = jnp.ones((n_rays,), jnp.float32)

        if use_nee:
            # separate folded key so the legacy (non-NEE) sample streams
            # are unchanged
            u_nee = _uniform_by_ray(jax.random.fold_in(bkey, 1), rid, 3)
            # Light-sample at every diffuse/glossy hit — NOT gated on this
            # bounce's own BSDF sample surviving (sc.ok): a fuzzy-metal
            # sample lands below the surface with probability 1-q, and
            # conditioning NEE on that independent event silently scales
            # the direct term by q (a real ~15% bias at glancing incidence
            # on fuzz 0.4). The absorbed path still earns this vertex's
            # direct light; only the continuation dies.
            take_direct = (active & ~sc.is_emissive
                           & (sc.is_diffuse | sc.is_glossy))
            n_exec = n_exec.at[1].add(jnp.float32(n_rays))
            direct, _ = lights_mod.direct_lighting(
                scene, rec.p, rec.normal, sc.attenuation, closest_hit_fn,
                u_nee, eps=t_min,
                glossy=(sc.is_glossy, sc.glossy_r, sc.fuzz))
            emitted_acc = emitted_acc + jnp.where(
                take_direct[:, None], atten * direct, 0.0)
            # fuzzy metal has a finite lobe -> it MIS-weights emissive hits
            # like diffuse; only delta lobes (fuzz-0 metal, dielectric)
            # keep full emissive weight
            spec_prev = jnp.where(step, sc.is_specular & ~sc.is_glossy,
                                  spec_prev)
            # solid-angle pdf of the direction this bounce sampled
            # (cosine lobe for lambertian, metal lobe for fuzzy metal;
            # unused under spec_prev)
            w_new = vec.safe_normalize(sc.direction)
            new_cos = jnp.maximum(vec.dot(rec.normal, w_new), 0.0)
            p_new = jnp.where(sc.is_glossy,
                              lights_mod.metal_lobe_pdf(w_new, sc.glossy_r,
                                                        sc.fuzz),
                              new_cos * vec.PI_INV)
            prev_pdf = jnp.where(step & take_direct, p_new, prev_pdf)

        step = step & ~killed
        absorbed = absorbed | killed
        o = jnp.where(step[:, None], rec.p, o)
        d = jnp.where(step[:, None], sc.direction, d)
        atten = jnp.where(step[:, None],
                          atten * sc.attenuation * survived_scale[:, None],
                          atten)
        # miss -> leave the loop, keep last direction for the sky lookup
        alive = alive & hit_valid & step
        return (o, d, atten, alive, absorbed, emitted_acc, spec_prev,
                prev_pdf, n_exec)

    atten0 = jnp.ones((n_rays, 3), jnp.float32)
    alive0 = jnp.ones((n_rays,), bool)
    absorbed0 = jnp.zeros((n_rays,), bool)
    emitted0 = jnp.zeros((n_rays, 3), jnp.float32)
    spec0 = jnp.ones((n_rays,), bool)  # camera rays count emissive hits
    pdf0 = jnp.zeros((n_rays,), jnp.float32)
    carry0 = (origin, direction, atten0, alive0, absorbed0, emitted0, spec0,
              pdf0, jnp.zeros((2,), jnp.float32))

    if differentiable:
        (o, d, atten, alive, absorbed, emitted_acc, _, _, n_exec), _ \
            = jax.lax.scan(
                lambda c, depth: (bounce_step(depth, c), None), carry0,
                jnp.arange(max_depth))
    else:
        def cond(state):
            depth, carry = state
            return (depth < max_depth) & jnp.any(carry[3])  # any alive

        def body(state):
            depth, carry = state
            return depth + 1, bounce_step(depth, carry)

        _, (o, d, atten, alive, absorbed, emitted_acc, _, _, n_exec) \
            = jax.lax.while_loop(cond, body, (jnp.int32(0), carry0))

    if sky:
        background = sky_color(d)
    else:
        background = jnp.zeros((n_rays, 3), jnp.float32)

    # Depth-exhausted rays are still 'alive': reference returns
    # sky * attenuation for them too (main.cu:26-36) unless terminate_black.
    dead = absorbed | (alive if terminate_black else jnp.zeros_like(absorbed))
    radiance = emitted_acc + jnp.where(dead[:, None], 0.0,
                                       atten * background)

    return (radiance, n_exec) if with_stats else radiance
