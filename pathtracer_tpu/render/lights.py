"""Area-light sampling for next-event estimation.

The reference has no emitters — its only light is the sky gradient
(``main.cu:34-36``) — so naive path tracing converges fine there. The
Cornell-box configs (BASELINE 1/2/5) are lit by a small area light, where
naive sampling needs thousands of spp; NEE (sampling a point on a light and
casting one shadow ray per diffuse bounce) is the standard fix.

Sampling is uniform over (light choice x surface area); the returned pdf is
with respect to area and already includes the 1/L light-choice factor.
Triangle emitters are double-sided (the reference's cornellbox ``light.obj``
ceiling quad has a single orientation).
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from pathtracer_tpu.core import sampling, vec
from pathtracer_tpu.scene.scene import PRIM_SPHERE, Scene

FOUR_PI = 4.0 * vec.PI


def sample_lights(scene: Scene, u: jnp.ndarray
                  ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray,
                             jnp.ndarray]:
    """Sample one point on one light per ray.

    ``u`` is (R, 3) of U[0,1) draws: [0] light choice, [1:3] surface sample.
    Returns (point (R,3), normal (R,3), emitted (R,3), pdf_area (R,)) with
    pdf including the uniform 1/L light-choice probability.
    Requires scene.num_lights > 0.
    """
    num_lights = scene.num_lights
    # small (L, 14) table of light geometry + emission, loop-invariant
    lv = scene.light_idx
    table = jnp.concatenate([
        jnp.take(scene.prim_type, lv, axis=0).astype(jnp.float32)[:, None],
        jnp.take(scene.v0, lv, axis=0),
        jnp.take(scene.e1, lv, axis=0),
        jnp.take(scene.e2, lv, axis=0),
        jnp.take(scene.radius, lv, axis=0)[:, None],
        jnp.take(scene.tri_normal, lv, axis=0),
        jnp.take(scene.emit, jnp.take(scene.prim_mat, lv, axis=0), axis=0),
    ], axis=1)

    li = jnp.clip((u[:, 0] * num_lights).astype(jnp.int32), 0,
                  num_lights - 1)
    rows = jnp.take(table, li, axis=0)
    ptype = rows[:, 0]
    v0 = rows[:, 1:4]
    e1 = rows[:, 4:7]
    e2 = rows[:, 7:10]
    radius = rows[:, 10]
    tri_n = rows[:, 11:14]
    emit = rows[:, 14:17]

    u1, u2 = u[:, 1], u[:, 2]

    # triangle: uniform barycentric (b1 = 1 - sqrt(u1), b2 = u2 * sqrt(u1))
    sq = jnp.sqrt(u1)
    b1 = 1.0 - sq
    b2 = u2 * sq
    p_tri = v0 + b1[:, None] * e1 + b2[:, None] * e2
    cr = vec.cross(e1, e2)
    area_tri = 0.5 * vec.length(cr)

    # sphere: uniform on the full surface
    omega = sampling.uniform_on_sphere(u1, u2)
    r_abs = jnp.abs(radius)
    p_sph = v0 + r_abs[:, None] * omega
    area_sph = FOUR_PI * r_abs * r_abs

    is_sphere = ptype == float(PRIM_SPHERE)
    point = jnp.where(is_sphere[:, None], p_sph, p_tri)
    normal = jnp.where(is_sphere[:, None], omega, tri_n)
    area = jnp.where(is_sphere, area_sph, area_tri)
    pdf = 1.0 / (jnp.maximum(area, 1e-12) * num_lights)
    return point, normal, emit, pdf


def metal_lobe_pdf(w_unit, r_unit, fuzz):
    """Exact solid-angle density of the RTIOW fuzzy-metal sampler.

    The reference draws v = r + fuzz * u with u uniform in the unit ball
    (material.h:39-42) and uses the *unnormalized* v as the next direction;
    the induced density of the unit direction w integrates the ball density
    along the ray t*w:

        p(w) = (t2^3 - t1^3) / (4 pi fuzz^3),  t1,2 = b -+ sqrt(b^2-1+f^2),

    with b = w.r (t1 clamped to 0). Sanity: fuzz -> 1 gives 2 cos^3 / pi
    around r, which integrates to 1 over the hemisphere. This is the lobe's
    own normalized pdf; the reference's below-surface absorption makes the
    *material* sub-probabilistic, which both sampling strategies share.
    """
    f = jnp.maximum(fuzz, 1e-4)
    b = vec.dot(w_unit, r_unit)
    disc = b * b - 1.0 + f * f
    inside = (disc > 0.0) & (b + jnp.sqrt(jnp.maximum(disc, 0.0)) > 0.0)
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = jnp.maximum(b - sq, 0.0)
    t2 = jnp.maximum(b + sq, 0.0)
    pdf = (t2 ** 3 - t1 ** 3) / (FOUR_PI * f ** 3)
    return jnp.where(inside, pdf, 0.0)


def direct_lighting(scene: Scene, rec_p, rec_normal, albedo, closest_hit_fn,
                    u, eps: float = 1e-3, mis: bool = True, glossy=None):
    """One-sample NEE estimate of direct radiance at a diffuse/glossy hit.

    L = w * albedo * p_lobe(w_l) * cos_l * emit / (dist^2 * pdf_area), where
    p_lobe is the material's own direction density (cos/pi for lambertian —
    reducing to the textbook albedo/pi * cos_s form — or the fuzzy-metal
    lobe via :func:`metal_lobe_pdf` when ``glossy=(is_glossy, r_unit, fuzz)``
    is given), and ``w`` the balance-heuristic MIS weight against BSDF
    sampling (the integrator adds the complementary weight to BSDF-sampled
    emissive hits, so light-through-specular paths stop being firefly-only).
    The shadow ray uses the *unnormalized* segment as its direction, so the
    light point sits at t == 1: any accepted hit with t < 1 - eps occludes.
    Returns (radiance (R,3), valid (R,) bool).
    """
    import jax

    point, n_l, emit, pdf = sample_lights(scene, u)
    # Self-intersection is prevented by an ABSOLUTE offset of the origin
    # along the shading normal; the shadow query itself then runs with the
    # near-zero parametric t_min K_SHADOW_T_MIN (every accel path's
    # ``query_shadow``; rationale in config.py) — a bounce-query t_min
    # would be a *proportional* ignore window (t_min x light distance) on
    # the unnormalized segment and leak contact shadows at Cornell scale.
    origin = rec_p + eps * rec_normal
    seg = point - origin
    dist2 = vec.dot(seg, seg)
    inv_dist = 1.0 / jnp.sqrt(jnp.maximum(dist2, 1e-12))
    cos_s = vec.dot(rec_normal, seg) * inv_dist
    cos_l = jnp.abs(vec.dot(n_l, seg)) * inv_dist  # double-sided emitter

    # the accel's near-zero-t_min shadow query when it offers one
    shadow_fn = getattr(closest_hit_fn, "query_shadow", closest_hit_fn)
    _, t_sh, sh_valid = shadow_fn(jax.lax.stop_gradient(origin),
                                  jax.lax.stop_gradient(seg))
    unoccluded = (~sh_valid) | (t_sh >= 1.0 - eps)

    p_lobe = jnp.maximum(cos_s, 0.0) * vec.PI_INV
    if glossy is not None:
        is_glossy, r_unit, fuzz = glossy
        w_l = seg * inv_dist[:, None]
        p_metal = metal_lobe_pdf(w_l, r_unit, fuzz)
        p_lobe = jnp.where(is_glossy, p_metal, p_lobe)
    geom = p_lobe * cos_l / (jnp.maximum(dist2, 1e-12) * pdf)
    radiance = albedo * geom[:, None] * emit
    if mis:
        # balance heuristic in solid-angle measure:
        # p_light = pdf_area * dist^2 / cos_l ; p_bsdf = p_lobe
        p_light = pdf * dist2 / jnp.maximum(cos_l, 1e-8)
        radiance = radiance * (p_light / (p_light + p_lobe))[:, None]
    ok = unoccluded & (cos_s > 0.0) & (cos_l > 0.0) & (p_lobe > 0.0)
    return jnp.where(ok[:, None], radiance, 0.0), ok


def bsdf_hit_light_weight(scene: Scene, rec, d, prev_pdf):
    """Balance-heuristic weight for a BSDF-sampled emissive hit.

    ``prev_pdf`` is the solid-angle pdf of the bounce that produced ray
    direction ``d`` (cosine-lobe pdf for lambertian). The competing
    strategy's pdf for the same point: area pdf of sampling the hit light
    (uniform over lights x area) converted to solid angle.
    """
    d_len = vec.length(d)
    dist = rec.t * d_len
    cos_l = jnp.abs(vec.dot(rec.normal, d)) / jnp.maximum(d_len, 1e-12)
    p_light = (dist * dist) / (jnp.maximum(cos_l, 1e-8)
                               * jnp.maximum(rec.prim_area, 1e-12)
                               * scene.num_lights)
    return prev_pdf / jnp.maximum(prev_pdf + p_light, 1e-20)
