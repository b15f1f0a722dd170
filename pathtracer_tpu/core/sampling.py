"""Stateless Monte Carlo samplers.

The reference keeps a per-pixel curand XORWOW state array
(``main.cu:262-269``) and draws with data-dependent rejection loops
(``utils/utility.h:51-82``). In a wavefront both are wrong: stateful RNG
serializes and rejection loops are divergent under vectorization. We use JAX's
counter-based threefry keys (key = fold(seed, pixel, sample, bounce)) and the
*analytic* samplers the reference also ships (``utility.h:84-102``) — they
draw from exactly the same distributions as the rejection versions:

- uniform-in-ball normalized  == uniform-on-sphere  (utility.h:51-62 vs 84-89)
- uniform-in-ball             == direction * cbrt(u) (utility.h:73-82 vs 64-71)
- the disk sampler is already analytic (utility.h:98-102)

All samplers take pre-drawn uniforms in [0, 1) so callers can batch a single
``jax.random.uniform`` call per bounce for the whole wavefront.
"""
from __future__ import annotations

import jax.numpy as jnp

from pathtracer_tpu.core import vec

TWO_PI = 2.0 * vec.PI


def uniform_on_sphere(u1, u2):
    """Uniform direction on the unit sphere (utility.h:84-89).

    phi = 2*pi*u1, cos(theta) = 1 - 2*u2.
    Returns (..., 3).
    """
    phi = TWO_PI * u1
    cos_theta = 1.0 - 2.0 * u2
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    return vec.v3(jnp.cos(phi) * sin_theta,
                  jnp.sin(phi) * sin_theta,
                  cos_theta)


def uniform_in_sphere(u1, u2, u3):
    """Uniform point in the unit ball (utility.h:64-71 analytic form)."""
    return uniform_on_sphere(u1, u2) * jnp.cbrt(u3)[..., None]


def uniform_on_hemisphere(u1, u2, normal):
    """Uniform direction in the hemisphere around ``normal``
    (utility.h:91-96: sphere sample, flipped to the normal's side)."""
    d = uniform_on_sphere(u1, u2)
    flip = jnp.where(vec.dot(d, normal, keepdims=True) > 0.0, 1.0, -1.0)
    return d * flip


def uniform_in_disk(u1, u2):
    """Uniform point in the unit disk, z = 0 (utility.h:98-102).

    r = sqrt(u1), theta = 2*pi*u2 — identical to the reference.
    """
    r = jnp.sqrt(u1)
    theta = TWO_PI * u2
    return vec.v3(r * jnp.cos(theta), r * jnp.sin(theta),
                  jnp.zeros_like(r))


def uniform_in_range(lo, hi, u):
    """u in [lo, hi); returns 0 when hi <= lo (utility.h:46-49)."""
    return jnp.where(hi <= lo, 0.0, u * (hi - lo) + lo)


# ---------------------------------------------------------------------------
# Owen-scrambled Sobol (pixel filter) — a quality extension beyond the
# reference's uniform jitter (main.cu:284-285): the (0,2)-sequence's pixel
# stratification converges ~O(1/n) on smooth integrands vs O(1/sqrt(n)) for
# independent uniforms, and hash-based Owen scrambling (Laine-Karras, as
# popularized by Burley 2020) decorrelates pixels without losing the net.
# Pure uint32 bit arithmetic — vectorizes cleanly, no state.

_SOBOL_DIR_1 = None  # lazily built (32,) uint32 direction numbers, dim 1


def _sobol_dir_1():
    global _SOBOL_DIR_1
    if _SOBOL_DIR_1 is None:
        import numpy as np
        v = np.zeros(32, np.uint32)
        v[0] = 1 << 31
        for j in range(1, 32):          # dim-1 recurrence (poly x + 1)
            v[j] = v[j - 1] ^ (v[j - 1] >> np.uint32(1))
        _SOBOL_DIR_1 = jnp.asarray(v)
    return _SOBOL_DIR_1


def _reverse_bits32(x):
    x = ((x >> 16) | (x << 16)) & jnp.uint32(0xFFFFFFFF)
    m = jnp.uint32(0x00FF00FF)
    x = ((x >> 8) & m) | ((x & m) << 8)
    m = jnp.uint32(0x0F0F0F0F)
    x = ((x >> 4) & m) | ((x & m) << 4)
    m = jnp.uint32(0x33333333)
    x = ((x >> 2) & m) | ((x & m) << 2)
    m = jnp.uint32(0x55555555)
    x = ((x >> 1) & m) | ((x & m) << 1)
    return x


def _laine_karras(x, seed):
    """Hash-based Owen scramble in the bit-reversed domain."""
    x = x + seed
    x = x ^ (x * jnp.uint32(0x6C50B47C))
    x = x ^ (x * jnp.uint32(0xB82F1E52))
    x = x ^ (x * jnp.uint32(0xC7AFE638))
    x = x ^ (x * jnp.uint32(0x8D22F6E6))
    return x


def _owen_scramble(x, seed):
    return _reverse_bits32(_laine_karras(_reverse_bits32(x), seed))


def _hash32(x):
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def sobol_owen_2d(sample_index, pixel_id, seed: int):
    """Per-pixel Owen-scrambled 2-D Sobol point for ``sample_index``.

    ``sample_index``: scalar (or (R,)) int — the global sample number;
    ``pixel_id``: (R,) int32/uint32 — each lane's pixel; ``seed``: python
    int. Returns (xi0, xi1), each (R,) f32 in [0, 1). Every pixel draws
    from its own Owen-scrambled copy of the sequence (shuffled index +
    per-dimension scrambles, all keyed on hash(pixel, seed)), so adjacent
    pixels are decorrelated while each pixel's sample set keeps the
    (0,2)-net stratification."""
    pid = pixel_id.astype(jnp.uint32)
    base = _hash32(pid ^ jnp.uint32(
        (seed * 0x9E3779B9 + 0x632BE59B) & 0xFFFFFFFF))
    idx = jnp.broadcast_to(jnp.asarray(sample_index, jnp.uint32), pid.shape)
    # Owen-shuffle the sample order per pixel (decorrelates pixels without
    # breaking the net: a permutation of a (0,2)-sequence prefix is only
    # guaranteed a net for power-of-two prefixes, which spp rounds hit)
    idx = _owen_scramble(idx, _hash32(base ^ jnp.uint32(0xA341316C)))

    # dim 0: van der Corput (bit reversal)
    d0 = _reverse_bits32(idx)
    # dim 1: direction-number matrix product
    v = _sobol_dir_1()
    d1 = jnp.zeros_like(idx)
    for j in range(32):
        bit = (idx >> jnp.uint32(j)) & jnp.uint32(1)
        d1 = d1 ^ (bit * v[j])
    d0 = _owen_scramble(d0, _hash32(base ^ jnp.uint32(0x51633E2D)))
    d1 = _owen_scramble(d1, _hash32(base ^ jnp.uint32(0x68BC21EB)))
    scale = jnp.float32(1.0 / (1 << 24))
    return ((d0 >> jnp.uint32(8)).astype(jnp.float32) * scale,
            (d1 >> jnp.uint32(8)).astype(jnp.float32) * scale)
