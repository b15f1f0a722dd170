"""Closest-hit as dense matmuls ("tensor sweep").

A dense alternative to pointer-chasing BVH traversal
(``utils/render_manager.h:86-135``): every per-(ray, primitive) intersection
scalar the tagged-union tests need (``cuda_object.h:45-90``) is an *affine
function of a 12-dim per-ray feature vector*

    phi(r) = [d, o, o x d, o.d, |o|^2, 1]          (R, 12)

against precomputed per-primitive columns, so the whole wavefront-vs-scene
sweep is one ``(R, 12) @ (12, 4N)`` matmul (f32-accurate via the bf16
"fused6" split, below) plus an elementwise epilogue and a masked argmin. No
gathers, no per-ray loops, no divergence.

Derivation (scalar-triple-product identities; ``det3[a,b,c] = a.(b x c)``):

- Möller–Trumbore (cuda_object.h:70-90), s1 = d x e2, s = o - v0,
  s2 = s x e1:
    det      = s1.e1 = d.(e2 x e1)
    t * det  = s2.e2 = o.(e1 x e2) - v0.(e1 x e2)
    b1 * det = s1.s  = (o x d).e2 - d.(e2 x v0)
    b2 * det = s2.d  = -(o x d).e1 - d.(v0 x e1)
- sphere (cuda_object.h:45-69), oc = o - c:
    half_b   = oc.d      = o.d - c.d
    c_term   = |oc|^2 - rho^2 = |o|^2 - 2 o.c + (|c|^2 - rho^2)
    (a = d.d stays a per-ray scalar)

The epilogue reproduces the reference's exact accept/reject semantics
(strict triangle edge rejection, two-root sphere selection, det == 0
parallel reject). Numerics differ from the factored forms at the ulp level
(different association order), which only matters for razor-edge hits.

Scaling: O(R * N). On a GPU the same sweep runs as one Triton kernel
(ops/pallas_sweep.py), which keeps the pair scalars out of device memory;
this XLA form is accel="auto" on other backends (config.resolve_accel).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from pathtracer_tpu.core import vec
from pathtracer_tpu.ops import intersect
from pathtracer_tpu.scene.scene import PRIM_SPHERE, Scene

FEAT = 12   # phi dimension
OUTS = 4    # pair scalars per primitive
BIG = 3.0e38  # python float: also usable inside Pallas kernels

# Matmul precision for the sweep. "fused6" (the default) computes
# HIGHEST's (bf16x6) six cross terms as ONE pre-expanded DEFAULT-precision
# bf16 matmul with f32 accumulation — values match HIGHEST to f32
# summation order (ulp), validated per scene against a float64 oracle
# (tools/sweep_validate.py: winner flips <= 5e-5). "highest" restores the
# enum form. default/high/bf16x3 are EXPERIMENTAL: on scenes with large
# coordinate extents the low-precision pair scalars flip closest-hit
# winners and visibly corrupt the image (bf16x3 fails triangle/bunny in
# tools/sweep_validate.py). Choosing the GPU arithmetic is open work
# (ROADMAP S6).
import os as _os
_SWEEP_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
    "bf16x3": jax.lax.Precision.HIGH,   # XLA paths: HIGH == bf16x3
}


def sweep_mode() -> str:
    """PT_SWEEP_PRECISION, read at *trace* time so an in-process toggle
    takes effect on the next compile — the renderer cache key covers
    PT_SWEEP_* (renderer._experiment_env_sig)."""
    return _os.environ.get("PT_SWEEP_PRECISION", "fused6").lower()


def sweep_dot(x, y):
    """The sweep contraction x @ y at the configured precision.

    In "fused6" mode (default) the operands are 6-block bf16 expanded on
    the fly and contracted once; in "bf16x3" the split-product runs
    explicitly; otherwise one dot_general with the enum. Splits use
    ``reduce_precision`` (split3_bf16's excess-precision note)."""
    if sweep_mode() == "fused6":
        return fused6_dot(expand6_lhs(x, axis=-1), expand6_rhs(y, axis=0))
    if sweep_mode() == "bf16x3":
        xh_f = jax.lax.reduce_precision(x, 8, 7)
        xh = xh_f.astype(jnp.bfloat16)
        xl = (x - xh_f).astype(jnp.bfloat16)
        yh_f = jax.lax.reduce_precision(y, 8, 7)
        yh = yh_f.astype(jnp.bfloat16)
        yl = (y - yh_f).astype(jnp.bfloat16)

        def d(u, v):
            return jax.lax.dot_general(
                u, v, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
        return d(xh, yh) + d(xh, yl) + d(xl, yh)
    return jax.lax.dot_general(
        x, y, (((1,), (0,)), ((), ())),
        precision=_SWEEP_PRECISIONS[sweep_mode()],
        preferred_element_type=jnp.float32)


def split3_bf16(x):
    """Exact 3-way bf16 split: hi + mid + lo == x bit-exactly (f32's 24-bit
    mantissa = 3 x 8-bit bf16 chunks; bf16 shares f32's exponent range).

    The split uses ``lax.reduce_precision``, not ``x - bf16(x)`` casts: a
    compiler allowed excess precision (XLA's
    ``--xla_allow_excess_precision``) may elide the f32->bf16->f32 round
    trip, folding the residual to zero and silently degenerating the
    6-term split to one bf16 pass. ``reduce_precision`` is the semantic
    rounding op that excess precision cannot remove; the final bf16
    converts are then exact, so eliding THEM is harmless."""
    hi_f = jax.lax.reduce_precision(x, 8, 7)
    r = x - hi_f
    mid_f = jax.lax.reduce_precision(r, 8, 7)
    lo_f = r - mid_f
    return (hi_f.astype(jnp.bfloat16), mid_f.astype(jnp.bfloat16),
            lo_f.astype(jnp.bfloat16))


# The "fused6" sweep: one bf16 matmul that computes the SAME six cross
# terms Precision.HIGHEST (bf16x6) computes — orders 0..2 of the 3-way
# splits x = x0+x1+x2, y = y0+y1+y2: x0y0, x0y1, x1y0, x1y1, x0y2, x2y0 —
# but as a single (.., 6*FEAT) @ (6*FEAT, ..) DEFAULT-precision contraction
# with f32 accumulation: one matmul instead of HIGHEST's six passes. Values differ from HIGHEST only in f32 summation
# order (ulp-level); the dropped terms (x1y2, x2y1, x2y2) are < 2^-48
# relative, far below f32 ulp. The two expansions MUST pair up: block b of
# the lhs expansion contracts against block b of the rhs expansion.
_FUSED6_LHS = (0, 0, 1, 1, 0, 2)
_FUSED6_RHS = (0, 1, 0, 1, 2, 0)


def expand6_lhs(x, axis=-1):
    """bf16 6-block expansion of the lhs (contraction on ``axis``)."""
    s = split3_bf16(x)
    return jnp.concatenate([s[i] for i in _FUSED6_LHS], axis=axis)


def expand6_rhs(x, axis=-1):
    """bf16 6-block expansion of the rhs (contraction on ``axis``)."""
    s = split3_bf16(x)
    return jnp.concatenate([s[i] for i in _FUSED6_RHS], axis=axis)


def fused6_dot(x6, y6):
    """The sweep contraction over pre-expanded fused6 operands:
    (R, 6*FEAT) @ (6*FEAT, cols) -> (R, cols) f32."""
    return jax.lax.dot_general(
        x6, y6, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)


class SweepTables(NamedTuple):
    """Packed per-primitive matmul columns + epilogue metadata."""
    cols: jnp.ndarray       # (T, FEAT, tile*OUTS) f32, tiled over prims
    is_sphere: jnp.ndarray  # (T, tile) bool
    valid_row: jnp.ndarray  # (T, tile) bool — False on padding rows
    tile: int
    num_prims: int


def pack_sweep_tables(scene: Scene, tile: int = 2048) -> SweepTables:
    """Build the (12, 4)-column table per primitive, tiled for the scan."""
    n = scene.num_prims
    # shrink the tile for small scenes (multiples of 128)
    tile = min(tile, max(128, -(-n // 128) * 128))
    v0, e1, e2 = scene.v0, scene.e1, scene.e2
    radius = scene.radius
    is_sphere = scene.prim_type == PRIM_SPHERE

    zeros = jnp.zeros((n, 3), jnp.float32)
    zcol = jnp.zeros((n,), jnp.float32)
    one = jnp.ones((n,), jnp.float32)

    # triangle columns
    e2xe1 = vec.cross(e2, e1)
    m = -e2xe1                        # e1 x e2
    e2xv0 = vec.cross(e2, v0)
    v0xe1 = vec.cross(v0, e1)
    col_det = jnp.concatenate([e2xe1, zeros, zeros,
                               zcol[:, None], zcol[:, None], zcol[:, None]],
                              axis=1)
    col_tdet = jnp.concatenate([zeros, m, zeros, zcol[:, None],
                                zcol[:, None], -vec.dot(v0, m)[:, None]],
                               axis=1)
    col_b1 = jnp.concatenate([-e2xv0, zeros, e2, zcol[:, None],
                              zcol[:, None], zcol[:, None]], axis=1)
    col_b2 = jnp.concatenate([-v0xe1, zeros, -e1, zcol[:, None],
                              zcol[:, None], zcol[:, None]], axis=1)

    # sphere columns (center = v0, signed radius)
    c = v0
    col_B = jnp.concatenate([-c, zeros, zeros, one[:, None],
                             zcol[:, None], zcol[:, None]], axis=1)
    col_C = jnp.concatenate([zeros, -2.0 * c, zeros, zcol[:, None],
                             one[:, None],
                             (vec.dot(c, c) - radius * radius)[:, None]],
                            axis=1)

    sph = is_sphere[:, None]
    k0 = jnp.where(sph, col_B, col_det)
    k1 = jnp.where(sph, col_C, col_tdet)
    k2 = jnp.where(sph, jnp.zeros_like(col_b1), col_b1)
    k3 = jnp.where(sph, jnp.zeros_like(col_b2), col_b2)
    # (N, OUTS, FEAT) -> pad N -> tiles
    cols = jnp.stack([k0, k1, k2, k3], axis=1)

    n_tiles = max(1, -(-n // tile))
    n_pad = n_tiles * tile
    cols = jnp.pad(cols, ((0, n_pad - n), (0, 0), (0, 0)))
    is_sphere_p = jnp.pad(is_sphere, (0, n_pad - n))
    valid_row = jnp.pad(jnp.ones(n, bool), (0, n_pad - n))

    # (T, tile, OUTS, FEAT) -> (T, FEAT, OUTS*tile), output-major:
    # output k occupies columns [k*tile, (k+1)*tile).
    cols = cols.reshape(n_tiles, tile, OUTS, FEAT)
    cols = cols.transpose(0, 3, 2, 1).reshape(n_tiles, FEAT, OUTS * tile)
    return SweepTables(cols=cols,
                       is_sphere=is_sphere_p.reshape(n_tiles, tile),
                       valid_row=valid_row.reshape(n_tiles, tile),
                       tile=tile, num_prims=n)


def ray_features(o, d):
    """phi = [d, o, o x d, o.d, |o|^2, 1] — (R, 12)."""
    w = vec.cross(o, d)
    return jnp.concatenate([
        d, o, w,
        vec.dot(o, d)[:, None],
        vec.dot(o, o)[:, None],
        jnp.ones((o.shape[0], 1), jnp.float32)], axis=1)


def _epilogue(B, C0, P2, P3, a, is_sphere, valid_row, t_min, t_max):
    """Pair scalars (R, tile) x4 -> per-pair effective t (R, tile), BIG on
    a miss. ``a`` is |d|^2, (R,); the masks are (tile,).

    Spheres: the quadratic with two-root selection (cuda_object.h:45-69),
    B = half_b, C0 = c. Triangles: Möller–Trumbore's strict rejections
    (cuda_object.h:70-90), the four scalars being det, t*det, b1*det and
    b2*det. The reference's six barycentric rejects reduce to three: b1 > 0,
    b2 > 0 and b1 + b2 < 1 together imply b1 < 1, b2 < 1 and b1 + b2 > 0,
    so the dropped comparisons can never flip the verdict on finite
    operands (non-finite pair scalars only arise on padding rows, which
    valid_row masks)."""
    a2 = a[:, None]
    disc = B * B - a2 * C0
    pos = disc > 0.0
    sqrt_d = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
    inv_a = 1.0 / a2
    root0 = (-B - sqrt_d) * inv_a
    root1 = (-B + sqrt_d) * inv_a
    ok0 = ~((root0 < t_min) | (t_max < root0))
    ok1 = ~((root1 < t_min) | (t_max < root1))
    t_sph = jnp.where(ok0, root0, root1)
    hit_sph = (disc >= 0.0) & (ok0 | ok1)

    det = B
    inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
    t_tri = C0 * inv_det
    b1 = P2 * inv_det
    b2 = P3 * inv_det
    hit_tri = ~((det == 0.0)
                | (b1 <= 0.0) | (b2 <= 0.0) | (b1 + b2 >= 1.0)
                | (t_tri <= t_min) | (t_tri >= t_max))

    v = valid_row[None, :]
    t_sph_eff = jnp.where(hit_sph & v, t_sph, BIG)
    t_tri_eff = jnp.where(hit_tri & v, t_tri, BIG)
    return jnp.where(is_sphere[None, :], t_sph_eff, t_tri_eff)


def tensor_closest(tables: SweepTables, o, d, t_min,
                   t_max) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Dense closest-hit: (prim_idx, t, valid), each (R,).

    Scans primitive tiles; per tile one sweep_dot matmul + epilogue
    + tile argmin merged into the running best. Ties go to the lowest
    primitive index (matches ops.intersect.brute_force_closest).
    """
    phi = ray_features(o, d)
    a = vec.dot(d, d)
    r = o.shape[0]
    tile = tables.tile

    def tile_step(carry, inputs):
        t_best, best = carry
        cols, sph, valid_row, base = inputs
        S = sweep_dot(phi, cols)
        t_eff = _epilogue(S[:, 0:tile], S[:, tile:2 * tile],
                          S[:, 2 * tile:3 * tile], S[:, 3 * tile:4 * tile],
                          a, sph, valid_row, t_min, t_max)
        j = jnp.argmin(t_eff, axis=1).astype(jnp.int32)
        t_tile = jnp.take_along_axis(t_eff, j[:, None], axis=1)[:, 0]
        better = t_tile < t_best
        best = jnp.where(better, base + j, best)
        t_best = jnp.where(better, t_tile, t_best)
        return (t_best, best), None

    n_tiles = tables.cols.shape[0]
    bases = jnp.arange(n_tiles, dtype=jnp.int32) * tile
    (t_best, best), _ = jax.lax.scan(
        tile_step,
        (jnp.full(r, intersect.BIG_T, jnp.float32),
         jnp.full(r, -1, jnp.int32)),
        (tables.cols, tables.is_sphere, tables.valid_row, bases))
    valid = best >= 0
    return jnp.where(valid, best, 0), t_best, valid


def make_tensor_closest_hit(scene: Scene, t_min: float, tile: int = 2048):
    """Closest-hit factory for the integrator (visibility is detached —
    SURVEY §7 step 6, same contract as the BVH/brute variants)."""
    tables = jax.tree_util.tree_map(
        lambda x: jax.lax.stop_gradient(x) if hasattr(x, "dtype") else x,
        pack_sweep_tables(scene, tile=tile))

    def closest(o, d):
        return tensor_closest(tables, o, d, jnp.float32(t_min),
                              intersect.BIG_T)
    return closest
