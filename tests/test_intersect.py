"""Intersection semantics tests against reference behavior
(cuda_object.h:44-92, aabb.h:21-34)."""
import jax.numpy as jnp
import numpy as np

from pathtracer_tpu.ops import intersect
from pathtracer_tpu.scene.scene import SceneBuilder


def _v(*xs):
    return jnp.array([xs], jnp.float32)


def test_sphere_two_root_selection():
    o = _v(0, 0, 5); d = _v(0, 0, -1)
    # near root at t=4, far at t=6
    hit, t = intersect.intersect_sphere(o, d, _v(0, 0, 0), jnp.array([1.0]),
                                        0.001, jnp.inf)
    assert bool(hit[0]) and np.isclose(float(t[0]), 4.0)
    # from inside: near root negative -> far root selected
    o = _v(0, 0, 0)
    hit, t = intersect.intersect_sphere(o, d, _v(0, 0, 0), jnp.array([1.0]),
                                        0.001, jnp.inf)
    assert bool(hit[0]) and np.isclose(float(t[0]), 1.0)
    # miss entirely
    hit, _ = intersect.intersect_sphere(_v(5, 5, 5), d, _v(0, 0, 0),
                                        jnp.array([1.0]), 0.001, jnp.inf)
    assert not bool(hit[0])


def test_negative_radius_normal_inward():
    """Hollow-glass trick: negative radius flips normals inward
    (cuda_object.h:24,62-64 + main.cu:233)."""
    b = SceneBuilder()
    m = b.add_dielectric(1.5)
    b.add_sphere((0, 0, 0), -0.9, m)
    scene = b.build()
    o = _v(0, 0, 5); d = _v(0, 0, -1)
    idx, t, valid = intersect.brute_force_closest(scene, o, d, 0.001,
                                                  intersect.BIG_T)
    rec = intersect.hit_records_from_prims(scene, idx, o, d, 0.001,
                                           intersect.BIG_T, valid)
    assert bool(valid[0])
    # outward normal points inward (-z face hit from +z side gives normal
    # +z/|r| -> sign-flipped by negative radius -> -z ... then face-forward
    # flips it back toward the ray: front_face False.
    assert not bool(rec.front_face[0])


def test_triangle_moller_trumbore():
    b = SceneBuilder()
    m = b.add_lambertian((1, 1, 1))
    b.add_triangle((-1, -1, 0), (1, -1, 0), (0, 1, 0), m)
    scene = b.build()
    o = _v(0, 0, 5); d = _v(0, 0, -1)
    hit, t, b1, b2 = intersect.intersect_triangle(
        o, d, scene.v0[:1], scene.e1[:1], scene.e2[:1], 0.001, jnp.inf)
    assert bool(hit[0]) and np.isclose(float(t[0]), 5.0)

    # strict-inequality edge rejection (cuda_object.h:83): a ray exactly
    # through vertex v0 has b1 = b2 = 0 -> MISS in the reference semantics
    o = _v(-1, -1, 5)
    hit, _, _, _ = intersect.intersect_triangle(
        o, d, scene.v0[:1], scene.e1[:1], scene.e2[:1], 0.001, jnp.inf)
    assert not bool(hit[0])

    # parallel ray (det == 0) rejected (cuda_object.h:74)
    o = _v(0, 0, 5); d_par = _v(1, 0, 0)
    hit, _, _, _ = intersect.intersect_triangle(
        o, d_par, scene.v0[:1], scene.e1[:1], scene.e2[:1], 0.001, jnp.inf)
    assert not bool(hit[0])


def test_aabb_slab():
    o = _v(0, 0, 5); d = _v(0, 0, -1)
    assert bool(intersect.ray_aabb_hit(o, d, _v(-1, -1, -1), _v(1, 1, 1),
                                       0.001, jnp.inf)[0])
    # behind the ray
    assert not bool(intersect.ray_aabb_hit(o, d, _v(-1, -1, 8), _v(1, 1, 9),
                                           0.001, jnp.inf)[0])
    # t_max prune
    assert not bool(intersect.ray_aabb_hit(o, d, _v(-1, -1, -1), _v(1, 1, 1),
                                           0.001, 1.0)[0])
    # axis-parallel ray inside slab (d component 0 -> inf/NaN path,
    # aabb.h NaN semantics)
    o = _v(0.5, 0.5, 5); d = _v(0, 0, -1)
    assert bool(intersect.ray_aabb_hit(o, d, _v(0, 0, 0), _v(1, 1, 1),
                                       0.001, jnp.inf)[0])
    # axis-parallel ray outside slab
    o = _v(2.0, 0.5, 5)
    assert not bool(intersect.ray_aabb_hit(o, d, _v(0, 0, 0), _v(1, 1, 1),
                                           0.001, jnp.inf)[0])


def test_closest_hit_ordering():
    """Linear scan picks the nearest hit (render_manager.h:71-84)."""
    b = SceneBuilder()
    m = b.add_lambertian((1, 1, 1))
    b.add_sphere((0, 0, -10), 1.0, m)
    b.add_sphere((0, 0, -5), 1.0, m)   # nearer, later in the list
    b.add_sphere((0, 0, -20), 1.0, m)
    scene = b.build()
    o = _v(0, 0, 0); d = _v(0, 0, -1)
    idx, t, valid = intersect.brute_force_closest(scene, o, d, 0.001,
                                                  intersect.BIG_T)
    assert bool(valid[0]) and int(idx[0]) == 1 and np.isclose(float(t[0]), 4.0)


def test_t_min_shadow_epsilon():
    """Hits closer than t_min=1e-3 are ignored (main.cu:27)."""
    b = SceneBuilder()
    m = b.add_lambertian((1, 1, 1))
    b.add_sphere((0, 0, 0), 1.0, m)
    scene = b.build()
    # origin exactly on the surface, pointing away: no self-hit
    o = _v(0, 0, 1); d = _v(0, 0, 1)
    _, _, valid = intersect.brute_force_closest(scene, o, d, 0.001,
                                                intersect.BIG_T)
    assert not bool(valid[0])
