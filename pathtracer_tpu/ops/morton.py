"""Morton (Z-order) codes for LBVH construction.

Bit-exact port of the reference's code math (``utils/morton_code.h:20-45``)
as vectorized uint32 ops, jittable on device — the reference computes codes
on the host and std::stable_sorts there (morton_code.h:64-75); here both the
code generation and the sort run on the device.

Key layout follows the reference's 64-bit union (morton_code.h:11-17):
key = (mortonCode << 32) | objectID, so the object id tie-breaks equal
codes in longest-common-prefix computations. Without uint64 we carry
(code, id) pairs and emulate clz64.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def expand_bits(v):
    """10-bit -> 30-bit interleave (morton_code.h:20-27), uint32."""
    v = v.astype(jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton3d(center, world_min, world_max):
    """Quantize box centers to 10 bits/axis in the scene AABB and
    interleave, x highest (morton_code.h:29-45). center: (..., 3)."""
    rng = world_max - world_min
    safe = rng > 1e-7
    norm = jnp.where(safe, (center - world_min) / jnp.where(safe, rng, 1.0),
                     0.0)
    q = jnp.clip(norm * 1024.0, 0.0, 1023.0)
    q = q.astype(jnp.uint32)
    xx = expand_bits(q[..., 0])
    yy = expand_bits(q[..., 1])
    zz = expand_bits(q[..., 2])
    return (xx << 2) + (yy << 1) + zz


def clz32(x):
    """Count leading zeros of uint32 (x=0 -> 32)."""
    return jax.lax.clz(x.astype(jnp.uint32)).astype(jnp.int32)


def clz64_pair(code_a, id_a, code_b, id_b):
    """clz of (code<<32|id)_a XOR (code<<32|id)_b — the reference's
    __clzll on the Morton union (morton_code.h:47-56) without uint64."""
    hi = code_a ^ code_b
    lo = (id_a.astype(jnp.uint32)) ^ (id_b.astype(jnp.uint32))
    hi_clz = clz32(hi)
    return jnp.where(hi == 0, 32 + clz32(lo), hi_clz)
