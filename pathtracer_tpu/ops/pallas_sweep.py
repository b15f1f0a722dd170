"""Triton kernel (Pallas, ``backend="triton"``): fused dense closest-hit.

The XLA form of the dense sweep (ops/tensor_sweep.py) writes the
(R, 4 x tile) pair-scalar block of every primitive tile to device memory
and reads it back for the epilogue; its contraction is only 12 deep, so
that round trip, not arithmetic, bounds it. This kernel keeps the whole
sweep on chip: one program owns a power-of-two block of rays and loops
over primitive tiles; each (ray, primitive) test, the running minimum and
the winner index live in registers, and only the per-ray (t_best,
best_idx) is stored.

Arithmetic: each pair runs the reference's own tests — the quadratic
sphere test and Möller–Trumbore with strict rejections — in f32 on the
CUDA cores, component by component in the same order as
``intersect.intersect_sphere`` / ``intersect.intersect_triangle``, so the
kernel agrees with the brute-force scan (``intersect.brute_force_closest``)
winner for winner. No ``dot``: Triton's f32 dot runs in TF32. Ties go to
the lowest primitive index.

The kernel compiles only for CUDA devices; ``interpret=True`` runs it
through the Pallas interpreter (tests on the CPU).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from pathtracer_tpu.scene.scene import PRIM_SPHERE, Scene

RAY_BLOCK = 64     # rays per program (power of two)
PRIM_TILE = 32     # primitives per loop step (power of two)
NUM_WARPS = 4
BIG = 3.0e38
_NO_HIT = 2 ** 31 - 1
# rows of the primitive table: v0 (sphere center) xyz, e1 xyz, e2 xyz,
# radius, sphere flag
_ROWS = 11


def pack_prim_table(scene: Scene, prim_tile: int = PRIM_TILE) -> jnp.ndarray:
    """(11, N) f32 primitive rows, N padded to a ``prim_tile`` multiple.
    Padding rows are triangles with zero edges: det == 0 rejects them."""
    n = scene.num_prims
    n_pad = -(-n // prim_tile) * prim_tile
    table = jnp.concatenate([
        scene.v0.T, scene.e1.T, scene.e2.T, scene.radius[None, :],
        (scene.prim_type == PRIM_SPHERE).astype(jnp.float32)[None, :]],
        axis=0).astype(jnp.float32)
    return jnp.pad(table, ((0, 0), (0, n_pad - n)))


def _pair_t(o, d, p, t_min, t_max):
    """Per-pair effective t (BIG on a miss) for rays o, d (3-tuples of
    (RB, 1)) against primitive rows p (11-tuple of (1, PT)). Mirrors
    intersect.intersect_sphere / intersect_triangle operation for
    operation."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, radius, is_sphere = p

    # sphere (cuda_object.h:45-69)
    ocx, ocy, ocz = ox - v0x, oy - v0y, oz - v0z
    a = dx * dx + dy * dy + dz * dz
    half_b = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - radius * radius
    disc = half_b * half_b - a * c
    pos = disc > 0.0
    sqrt_d = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
    inv_a = 1.0 / a
    root0 = (-half_b - sqrt_d) * inv_a
    root1 = (-half_b + sqrt_d) * inv_a
    ok0 = ~((root0 < t_min) | (t_max < root0))
    ok1 = ~((root1 < t_min) | (t_max < root1))
    t_sph = jnp.where(ok0, root0, root1)
    hit_sph = (disc >= 0.0) & (ok0 | ok1)

    # triangle: Möller–Trumbore with strict rejections (cuda_object.h:70-90)
    s1x = dy * e2z - dz * e2y
    s1y = dz * e2x - dx * e2z
    s1z = dx * e2y - dy * e2x
    det = s1x * e1x + s1y * e1y + s1z * e1z
    inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    s2x = sy * e1z - sz * e1y
    s2y = sz * e1x - sx * e1z
    s2z = sx * e1y - sy * e1x
    t_tri = (s2x * e2x + s2y * e2y + s2z * e2z) * inv_det
    b1 = (s1x * sx + s1y * sy + s1z * sz) * inv_det
    b2 = (s2x * dx + s2y * dy + s2z * dz) * inv_det
    miss = ((det == 0.0)
            | (b1 >= 1.0) | (b1 <= 0.0)
            | (b2 >= 1.0) | (b2 <= 0.0)
            | (b1 + b2 <= 0.0) | (b1 + b2 >= 1.0)
            | (t_tri <= t_min) | (t_tri >= t_max))

    sph = is_sphere != 0.0
    hit = jnp.where(sph, hit_sph, ~miss)
    return jnp.where(hit, jnp.where(sph, t_sph, t_tri), BIG)


def _sweep_kernel(o_ref, d_ref, prim_ref, t_ref, idx_ref, *, ray_block,
                  prim_tile, n_tiles, t_min):
    rows = pl.ds(pl.program_id(0) * ray_block, ray_block)
    o = tuple(o_ref[k, rows][:, None] for k in range(3))
    d = tuple(d_ref[k, rows][:, None] for k in range(3))

    def tile_step(j, carry):
        t_best, best = carry
        cs = pl.ds(j * prim_tile, prim_tile)
        p = tuple(prim_ref[k, cs][None, :] for k in range(_ROWS))
        t_eff = _pair_t(o, d, p, t_min, BIG)
        t_tile = jnp.min(t_eff, axis=1)
        ids = j * prim_tile + jnp.arange(prim_tile, dtype=jnp.int32)
        j_tile = jnp.min(jnp.where(t_eff == t_tile[:, None], ids[None, :],
                                   _NO_HIT), axis=1)
        better = t_tile < t_best
        return (jnp.where(better, t_tile, t_best),
                jnp.where(better, j_tile, best))

    t_best, best = jax.lax.fori_loop(
        0, n_tiles, tile_step,
        (jnp.full((ray_block,), BIG, jnp.float32),
         jnp.full((ray_block,), -1, jnp.int32)))
    t_ref[rows] = t_best
    idx_ref[rows] = best


def pallas_closest(table: jnp.ndarray, o, d, t_min: float,
                   ray_block: int = RAY_BLOCK, prim_tile: int = PRIM_TILE,
                   num_warps: int = NUM_WARPS, interpret: bool = False
                   ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fused closest-hit over a :func:`pack_prim_table` table: (prim_idx,
    t, valid), each (R,). Any R: the wavefront is padded to a
    ``ray_block`` multiple with copies of its first ray, sliced off after."""
    r = o.shape[0]
    r_pad = -(-r // ray_block) * ray_block
    n = table.shape[1]
    assert n % prim_tile == 0, (n, prim_tile)
    o_t, d_t = o.T, d.T
    if r_pad != r:
        o_t = jnp.pad(o_t, ((0, 0), (0, r_pad - r)), mode="edge")
        d_t = jnp.pad(d_t, ((0, 0), (0, r_pad - r)), mode="edge")
    kernel = functools.partial(_sweep_kernel, ray_block=ray_block,
                               prim_tile=prim_tile, n_tiles=n // prim_tile,
                               t_min=float(t_min))
    t_best, best = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((r_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((r_pad,), jnp.int32)),
        grid=(r_pad // ray_block,),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="dense_sweep",
    )(o_t, d_t, table)
    t_best, best = t_best[:r], best[:r]
    found = best >= 0
    return jnp.where(found, best, 0), t_best, found


def make_pallas_closest_hit(scene: Scene, t_min: float,
                            interpret: bool = False):
    """Closest-hit factory (visibility detached, same contract as the
    tensor/bvh/brute variants)."""
    table = jax.lax.stop_gradient(pack_prim_table(scene))

    def closest(o, d):
        return pallas_closest(table, o, d, t_min, interpret=interpret)
    return closest
