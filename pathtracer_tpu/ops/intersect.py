"""Branch-free ray/primitive intersection, vectorized over (ray, prim) pairs.

Wavefront replacement for the reference's per-thread tagged-union dispatch
(``simulation/cuda_object.h:44-92``): every test is evaluated on dense
arrays and the winner selected by masks — no divergent branches. Exact
reference semantics are preserved:

- sphere: quadratic with two-root selection (cuda_object.h:45-69),
- triangle: Möller–Trumbore with *strict*-inequality edge rejection and
  ``det == 0`` parallel reject (cuda_object.h:70-90) — rays that graze an
  edge exactly miss, as in the reference (SURVEY §7 quirk table),
- AABB: slab test with the reference's NaN behavior — comparisons use
  ``t0 > t_min ? t0 : t_min`` selects, so NaNs fall through to the running
  bound exactly like fmaxf/fminf do in CUDA (utils/aabb.h:21-34).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from pathtracer_tpu.core import rays as rays_mod
from pathtracer_tpu.core import vec
from pathtracer_tpu.scene.scene import PRIM_SPHERE, Scene

BIG_T = jnp.float32(3.0e38)


def ray_aabb_hit(o, d, bmin, bmax, t_min, t_max):
    """Slab test (aabb.h:21-34). All args broadcastable; o/d/bmin/bmax are
    (..., 3); t_min/t_max are (...,). Returns bool (...,).

    The reference iterates axes updating running [t_min, t_max] with ternary
    selects and fails on ``t_max < t_min``; order across axes is immaterial,
    so we evaluate all axes at once with where-selects that replicate the
    NaN-falls-through behavior of the ternaries."""
    inv = 1.0 / d
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    swap = inv < 0.0
    lo = jnp.where(swap, t1, t0)
    hi = jnp.where(swap, t0, t1)
    # running max of entry times / min of exit times, NaN-dropping:
    tmin_r = t_min
    tmax_r = t_max
    for a in range(3):
        tmin_r = jnp.where(lo[..., a] > tmin_r, lo[..., a], tmin_r)
        tmax_r = jnp.where(hi[..., a] < tmax_r, hi[..., a], tmax_r)
    return ~(tmax_r < tmin_r)


def intersect_sphere(o, d, center, radius, t_min, t_max):
    """Quadratic sphere test (cuda_object.h:45-69).

    Returns (hit, t). Nearest root in range preferred, else the far root.
    ``radius`` is signed — the sign only affects the normal direction, which
    is recomputed in :func:`hit_records_from_prims`."""
    oc = o - center
    a = vec.dot(d, d)
    half_b = vec.dot(oc, d)
    c = vec.dot(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    # Grad-safe sqrt: for missing rays (disc <= 0) the hit is masked out, but
    # a plain sqrt(max(disc, 0)) still backprops 0-cotangent * inf = NaN into
    # center/radius. Same forward value, finite gradient everywhere.
    hit_mask = disc > 0.0
    sqrt_d = jnp.where(hit_mask,
                       jnp.sqrt(jnp.where(hit_mask, disc, 1.0)), 0.0)
    inv_a = 1.0 / a
    root0 = (-half_b - sqrt_d) * inv_a
    root1 = (-half_b + sqrt_d) * inv_a
    ok0 = ~((root0 < t_min) | (t_max < root0))
    ok1 = ~((root1 < t_min) | (t_max < root1))
    t = jnp.where(ok0, root0, root1)
    hit = (disc >= 0.0) & (ok0 | ok1)
    return hit, t


def intersect_triangle(o, d, v0, e1, e2, t_min, t_max):
    """Möller–Trumbore (cuda_object.h:70-90) with the reference's strict
    rejections: det == 0 parallel reject; miss if b1/b2/b1+b2 outside the
    *open* interval (0, 1) or t outside the open (t_min, t_max).

    Returns (hit, t, b1, b2)."""
    s1 = vec.cross(d, e2)
    det = vec.dot(s1, e1)
    inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)  # guarded; det==0 masked
    s = o - v0
    s2 = vec.cross(s, e1)
    t = vec.dot(s2, e2) * inv_det
    b1 = vec.dot(s1, s) * inv_det
    b2 = vec.dot(s2, d) * inv_det
    miss = ((det == 0.0)
            | (b1 >= 1.0) | (b1 <= 0.0)
            | (b2 >= 1.0) | (b2 <= 0.0)
            | (b1 + b2 <= 0.0) | (b1 + b2 >= 1.0)
            | (t <= t_min) | (t >= t_max))
    return ~miss, t, b1, b2


def intersect_prims(o, d, prim_type, v0, e1, e2, radius, t_min, t_max):
    """Unified tagged-union test (cuda_object.h:44-92) over broadcastable
    (ray, prim) arrays. Computes both primitive tests densely and selects by
    the type tag — branch-free. Returns (hit, t)."""
    s_hit, s_t = intersect_sphere(o, d, v0, radius, t_min, t_max)
    t_hit, t_t, _, _ = intersect_triangle(o, d, v0, e1, e2, t_min, t_max)
    is_sphere = prim_type == PRIM_SPHERE
    return jnp.where(is_sphere, s_hit, t_hit), jnp.where(is_sphere, s_t, t_t)


def brute_force_closest(scene: Scene, o, d, t_min, t_max):
    """Linear-scan closest hit over all primitives — the reference's own
    fallback path (render_manager.h:71-84), as a dense (R, N) sweep.

    Returns (prim_idx (R,) int32, t (R,), valid (R,) bool). Ties in t go to
    the lowest primitive index (argmin), which matches the reference's
    ascending sequential scan for triangles; for exactly-equal sphere hits
    the reference would keep the *later* object — a measure-zero divergence
    we accept (SURVEY §2.1)."""
    hit, t = intersect_prims(
        o[:, None, :], d[:, None, :],
        scene.prim_type[None, :], scene.v0[None, :, :],
        scene.e1[None, :, :], scene.e2[None, :, :],
        scene.radius[None, :],
        t_min, t_max)
    t_eff = jnp.where(hit, t, BIG_T)
    idx = jnp.argmin(t_eff, axis=1).astype(jnp.int32)
    t_best = jnp.take_along_axis(t_eff, idx[:, None], axis=1)[:, 0]
    valid = t_best < BIG_T
    return idx, t_best, valid


def hit_records_from_prims(scene: Scene, idx, o, d, t_min, t_max,
                           valid) -> rays_mod.HitRecords:
    """Differentiable hit-record reconstruction.

    Given the (detached) winning primitive index per ray, recompute t / p /
    normal / uv in closed form so gradients flow to vertices and centers
    (detached-visibility estimator: the discrete choice ``idx`` is treated
    as constant, the geometry is differentiable). Mirrors what
    cuda_object.h:45-92 writes into the hit_record, including the sphere UV
    (cuda_object.h:94-102) and the face-normal flip (hit_record.h:21-24)."""
    # One packed-row gather instead of seven; its backward (a scatter-add)
    # carries the v0/e1/e2 gradients.
    packed = jnp.concatenate([
        scene.prim_type.astype(jnp.float32)[:, None],
        scene.v0, scene.e1, scene.e2,
        scene.radius[:, None], scene.tri_normal,
        scene.prim_mat.astype(jnp.float32)[:, None],
    ], axis=1)
    rows = jnp.take(packed, idx, axis=0)

    def f(i):
        return rows[:, i]

    def f3(i):
        return rows[:, i:i + 3]
    ptype = f(0).astype(jnp.int32)
    v0 = f3(1)
    e1 = f3(4)
    e2 = f3(7)
    radius = f(10)
    tri_n = f3(11)
    mat_id = f(14).astype(jnp.int32)

    s_hit, s_t = intersect_sphere(o, d, v0, radius, t_min, t_max)
    tr_hit, tr_t, b1, b2 = intersect_triangle(o, d, v0, e1, e2, t_min, t_max)

    is_sphere = ptype == PRIM_SPHERE
    t = jnp.where(is_sphere, s_t, tr_t)
    p = o + t[:, None] * d

    # Sphere outward normal: (p - center) / radius — signed radius flips the
    # normal inward for hollow-glass interiors (cuda_object.h:62-64). Radius
    # is guarded against 0 (padding rows) to keep values/grads NaN-free under
    # the type-select below.
    safe_r = jnp.where(radius == 0.0, 1.0, radius)
    sph_n = (p - v0) / safe_r[:, None]
    outward = jnp.where(is_sphere[:, None], sph_n, tri_n)
    front_face, normal = rays_mod.set_face_normal(d, outward)

    # Sphere UV (cuda_object.h:94-102); triangles leave uv = 0 like the
    # reference (its hit() never writes u/v for triangles). Both inverse-trig
    # ops have unbounded/undefined derivatives at the poles (|y| = 1,
    # x = z = 0), which would NaN the v0 gradient even under a zero
    # cotangent; evaluate the value exactly and the gradient at a nudged
    # point (value + stop_gradient correction).
    y = jnp.clip(-sph_n[:, 1], -1.0, 1.0)
    y_safe = jnp.clip(y, -1.0 + 1e-6, 1.0 - 1e-6)
    theta = (jnp.arccos(y_safe)
             + jax.lax.stop_gradient(jnp.arccos(y) - jnp.arccos(y_safe)))
    x, z = sph_n[:, 0], -sph_n[:, 2]
    on_pole = (x * x + z * z) < 1e-12
    x_safe = jnp.where(on_pole, 1.0, x)
    z_safe = jnp.where(on_pole, 0.0, z)
    # atan2(0, 1) == atan2(0, 0) == 0, so the forward value is unchanged.
    phi = jnp.arctan2(z_safe, x_safe) + vec.PI
    u = phi * 0.5 * vec.PI_INV
    v = theta * vec.PI_INV
    uv = jnp.where(is_sphere[:, None],
                   jnp.stack([u, v], axis=-1),
                   jnp.zeros((idx.shape[0], 2), jnp.float32))

    # surface area (sphere 4*pi*r^2 / triangle |e1 x e2|/2) — the area-pdf
    # term for MIS against light sampling (render/lights.py)
    area_sph = 4.0 * vec.PI * radius * radius
    area_tri = 0.5 * vec.length(vec.cross(e1, e2))
    prim_area = jnp.where(is_sphere, area_sph, area_tri)

    return rays_mod.HitRecords(
        p=p, normal=normal, mat_id=mat_id, t=t, uv=uv,
        front_face=front_face, valid=valid, prim_id=idx,
        prim_area=prim_area)
