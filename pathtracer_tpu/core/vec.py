"""3-vector math over ``(..., 3)`` arrays.

Wavefront counterpart of the reference's scalar ``vectorgpu::vec3``
(reference ``utils/vec3.h:10-104``): instead of a per-thread 3-float struct,
every operation is batched over leading axes so the device sees wide, regular
work. Colors and points are plain ``(..., 3)`` float32 arrays.
"""
from __future__ import annotations

import jax.numpy as jnp

# Reference constants (utils/global_variables.h:13-20).
PI = 3.1415926535897932385
PI_INV = 0.31830988618
DEG_TO_RAD = 0.01745329252
INFINITY = jnp.inf

NEAR_ZERO_EPS = 1e-7  # utils/vec3.h:67


def v3(x, y, z, dtype=jnp.float32):
    """Build a (..., 3) vector by stacking components on the last axis."""
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)),
        axis=-1)


def dot(a, b, keepdims: bool = False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a, b):
    # Spelled out (rather than jnp.cross) so it fuses cleanly and works
    # inside Pallas kernels.
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack([ay * bz - az * by,
                      az * bx - ax * bz,
                      ax * by - ay * bx], axis=-1)


def length_squared(a, keepdims: bool = False):
    return dot(a, a, keepdims=keepdims)


def length(a, keepdims: bool = False):
    return jnp.sqrt(length_squared(a, keepdims=keepdims))


def normalize(a):
    """Exact reference semantics: v / |v| (utils/vec3.h) — no epsilon."""
    return a / length(a, keepdims=True)


def safe_normalize(a, eps: float = 1e-20):
    """Gradient-safe normalize for the differentiable path."""
    n2 = length_squared(a, keepdims=True)
    return a / jnp.sqrt(jnp.maximum(n2, eps))


def safe_sqrt(x):
    """sqrt(max(x, 0)) with a finite gradient at x <= 0.

    A plain ``sqrt(maximum(x, 0))`` backprops cotangent * inf = NaN wherever
    x <= 0 — even a zero cotangent (branch masked out by ``where``) poisons
    upstream gradients. Used on every masked discriminant/sine term in the
    differentiable path.
    """
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def near_zero(a):
    """True where all components are < 1e-7 in magnitude (vec3.h:66-69)."""
    return jnp.all(jnp.abs(a) < NEAR_ZERO_EPS, axis=-1)


def lerp(a, b, t):
    return (1.0 - t) * a + t * b


def degrees_to_radians(deg):
    return deg * DEG_TO_RAD
