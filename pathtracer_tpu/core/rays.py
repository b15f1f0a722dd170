"""Ray and hit-record SoA pytrees.

The reference carries one ``Ray`` / ``hit_record`` per thread
(``simulation/ray.h:8-25``, ``simulation/hit_record.h:12-25``). Here a whole
wavefront is one pytree of ``(N, ...)`` arrays — structure-of-arrays so every
field is a contiguous, vector-friendly buffer.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from pathtracer_tpu.core import vec


class Rays(NamedTuple):
    """A batch of N rays: origin, direction, shutter time."""
    origin: jnp.ndarray     # (N, 3)
    direction: jnp.ndarray  # (N, 3)
    time: jnp.ndarray       # (N,)

    def at(self, t):
        """Point at parameter t (ray.h:18-20)."""
        return self.origin + t[..., None] * self.direction


class HitRecords(NamedTuple):
    """Closest-hit results for a batch of N rays (hit_record.h:12-25)."""
    p: jnp.ndarray          # (N, 3) hit point
    normal: jnp.ndarray     # (N, 3) face-forward normal
    mat_id: jnp.ndarray     # (N,) int32
    t: jnp.ndarray          # (N,)
    uv: jnp.ndarray         # (N, 2)
    front_face: jnp.ndarray  # (N,) bool
    valid: jnp.ndarray      # (N,) bool — did the ray hit anything
    prim_id: jnp.ndarray    # (N,) int32 — which primitive (for diff re-eval)
    prim_area: jnp.ndarray  # (N,) surface area of the hit prim (MIS pdfs)


def set_face_normal(direction, outward_normal):
    """Face-forward normal flip (hit_record.h:21-24).

    Returns (front_face, normal) where normal opposes the ray direction.
    """
    front_face = vec.dot(direction, outward_normal) < 0.0
    normal = jnp.where(front_face[..., None], outward_normal, -outward_normal)
    return front_face, normal
