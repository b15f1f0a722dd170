"""Branch-free material shading over a wavefront.

The reference dispatches per-thread on a tagged-union ``Material::scatter``
(``simulation/material.h:28-61``). Here all three lobes are evaluated densely
for every ray and the result selected by the material-type mask — the
deprecated/ virtual-dispatch -> tagged-union move taken one step further into
pure data parallelism (SURVEY §2.1, deprecated/ row).

Texture support wires up the reference's dangling ``mTexID`` field
(material.h:64) and stub ``simulation/texture.h``: lambertian albedo is
modulated by an image texture looked up at the hit UV when tex_id >= 0.

Emissive materials are an extension (tag 8): the reference's only light is
the sky; its shipped Cornell-box ``light.obj`` asset implies an emitter.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pathtracer_tpu.core import optics, sampling, vec
from pathtracer_tpu.core.rays import HitRecords
from pathtracer_tpu.scene.scene import (MAT_DIELECTRIC, MAT_EMISSIVE,
                                        MAT_LAMBERTIAN, MAT_METAL, Scene)


class ScatterResult(NamedTuple):
    direction: jnp.ndarray    # (N, 3) next ray direction
    attenuation: jnp.ndarray  # (N, 3)
    ok: jnp.ndarray           # (N,) bool — False = absorbed (metal, material.h:43)
    emitted: jnp.ndarray      # (N, 3) radiance emitted at the hit
    is_emissive: jnp.ndarray  # (N,) bool — path terminates at an emitter
    is_diffuse: jnp.ndarray   # (N,) bool — lambertian (NEE samples lights)
    is_specular: jnp.ndarray  # (N,) bool — metal/dielectric (emissive hits
                              # stay counted after these under NEE)
    is_glossy: jnp.ndarray    # (N,) bool — fuzzy metal (finite lobe: NEE
                              # light-samples it too, render/lights.py)
    glossy_r: jnp.ndarray     # (N, 3) unit mirror direction of the metal lobe
    fuzz: jnp.ndarray         # (N,) metal fuzz radius


def sample_texture(scene: Scene, tex_id, uv):
    """Nearest-neighbor image texture lookup at (u, v); v=0 is the bottom
    row (sphere UV convention, cuda_object.h:94-102).

    Two-stage fetch: stage 1 gathers each ray's scanline ``(tex, y)``;
    stage 2 selects the x texel with a one-hot masked sum, whose backward
    stays a dense select rather than a scatter.
    """
    k, th, tw = (scene.textures.shape[0], scene.textures.shape[1],
                 scene.textures.shape[2])
    if k == 0:
        return jnp.ones(uv.shape[:-1] + (3,), jnp.float32)
    u = jnp.clip(uv[..., 0], 0.0, 1.0)
    v = jnp.clip(uv[..., 1], 0.0, 1.0)
    # texel clamp: v == 0 maps to y == th and u == 1 to x == tw (one past the
    # last texel) — clamp so the seam/pole rows resolve to the edge texel on
    # every path (unclamped, the one-hot select returned black there)
    x = jnp.minimum((u * tw).astype(jnp.int32), tw - 1)
    y = jnp.minimum(((1.0 - v) * th).astype(jnp.int32), th - 1)
    tid = jnp.clip(tex_id, 0, k - 1)
    scanlines = scene.textures.reshape(k * th, tw * 3)
    rows = jnp.take(scanlines, tid * th + y, axis=0)
    rows3 = rows.reshape(rows.shape[0], tw, 3)
    sel = (jax.lax.broadcasted_iota(jnp.int32, (rows.shape[0], tw), 1)
           == x[:, None])
    return jnp.sum(jnp.where(sel[:, :, None], rows3, 0.0), axis=1)


def scatter(scene: Scene, rec: HitRecords, in_dir, uniforms) -> ScatterResult:
    """Evaluate all material lobes for a wavefront of hits.

    ``uniforms`` is (N, 6) of U[0,1) draws: [0:2] sphere-surface sample
    (lambertian), [2:5] in-sphere sample (metal fuzz), [5] the dielectric
    reflect/refract coin. One ``jax.random.uniform`` call feeds the whole
    bounce — the stateless replacement for per-thread curand draws.
    """
    # Single packed-row gather for all material fields. Integer tags ride
    # as f32 (exact below 2^24); albedo/emit keep grads through concatenate
    # + the gather's scatter-add backward.
    packed = jnp.concatenate([
        scene.mat_type.astype(jnp.float32)[:, None],
        scene.albedo,
        scene.fuzz[:, None], scene.ir[:, None],
        scene.emit,
        scene.tex_id.astype(jnp.float32)[:, None],
    ], axis=1)
    rows = jnp.take(packed, rec.mat_id, axis=0)
    mtype = rows[:, 0].astype(jnp.int32)
    albedo = rows[:, 1:4]
    fuzz = rows[:, 4]
    ir = rows[:, 5]
    emit = rows[:, 6:9]
    tex_id = rows[:, 9].astype(jnp.int32)

    n = rec.normal

    # --- lambertian (material.h:31-38): normal + on-sphere sample, with the
    # near-zero fallback to the bare normal.
    sphere_sample = sampling.uniform_on_sphere(uniforms[:, 0], uniforms[:, 1])
    lamb_dir = n + sphere_sample
    lamb_dir = jnp.where(vec.near_zero(lamb_dir)[:, None], n, lamb_dir)
    lamb_albedo = albedo
    if scene.textures.shape[0] > 0:
        tex = sample_texture(scene, tex_id, rec.uv)
        lamb_albedo = jnp.where((tex_id >= 0)[:, None], albedo * tex, albedo)

    # --- metal (material.h:39-44): reflect + fuzz * in-sphere; absorbed when
    # the fuzzed direction points below the surface.
    unit_in = vec.normalize(in_dir)
    reflected = optics.reflect(unit_in, n)
    fuzz_vec = sampling.uniform_in_sphere(uniforms[:, 2], uniforms[:, 3],
                                          uniforms[:, 4])
    metal_dir = reflected + fuzz[:, None] * fuzz_vec
    metal_ok = vec.dot(metal_dir, n) > 0.0

    # --- dielectric (material.h:45-58): Schlick-probabilistic reflect/refract.
    # ir guard: non-dielectric rows carry ir = 0, and although the dielectric
    # lobe is masked out for them, an unguarded 1/0 feeds inf into refract's
    # graph and NaNs the normal/vertex gradients (0-cotangent * inf).
    ir = jnp.where(mtype == MAT_DIELECTRIC, ir, 1.0)
    ratio = jnp.where(rec.front_face, 1.0 / ir, ir)
    cos_theta = jnp.minimum(vec.dot(-unit_in, n), 1.0)
    sin_theta = vec.safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = ratio * sin_theta > 1.0
    schlick = optics.reflectance(cos_theta, ratio)
    use_reflect = cannot_refract | (schlick > uniforms[:, 5])
    diel_dir = jnp.where(use_reflect[:, None],
                         optics.reflect(unit_in, n),
                         optics.refract(unit_in, n, ratio))

    is_lamb = (mtype == MAT_LAMBERTIAN)[:, None]
    is_metal = (mtype == MAT_METAL)[:, None]
    is_diel = (mtype == MAT_DIELECTRIC)[:, None]
    is_emissive = mtype == MAT_EMISSIVE

    direction = jnp.where(is_lamb, lamb_dir,
                          jnp.where(is_metal, metal_dir, diel_dir))
    attenuation = jnp.where(is_lamb, lamb_albedo,
                            jnp.where(is_metal, albedo,
                                      jnp.ones_like(albedo)))
    ok = jnp.where(is_metal[:, 0], metal_ok, ~is_emissive)
    emitted = jnp.where(is_emissive[:, None], emit, jnp.zeros_like(emit))
    is_glossy = is_metal[:, 0] & (fuzz > 0.0)
    return ScatterResult(direction=direction, attenuation=attenuation,
                         ok=ok, emitted=emitted, is_emissive=is_emissive,
                         is_diffuse=is_lamb[:, 0],
                         is_specular=is_metal[:, 0] | is_diel[:, 0],
                         is_glossy=is_glossy, glossy_r=reflected, fuzz=fuzz)
