"""Stackless (threaded) BVH traversal over a ray wavefront.

Replaces the reference's per-thread 64-slot traversal stack
(``utils/render_manager.h:86-135``) with escape-link threading: each ray
carries a single node pointer; at an internal node a box hit descends to the
left child and a miss follows the precomputed ``escape`` link (next subtree
in depth-first order); leaves intersect their primitive and follow escape.
The per-ray state is (ptr, t_best, best_prim) — three values instead of a
stack, so the whole wavefront steps as dense arrays.

Data layout is gather-optimal: one fused "fat node" table holding box + leaf
geometry + links, so each traversal step costs exactly one row gather per
table. The DONE sentinel indexes a dummy row whose box never hits and whose
escape points at itself, so finished rays idle without extra masking.

The query is visibility-only (returns discrete winner index); geometry is
re-evaluated differentiably outside (ops/intersect.hit_records_from_prims),
so this whole routine sits behind stop_gradient — detached-visibility
estimator (SURVEY §7 step 6).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from pathtracer_tpu.accel.lbvh import LBVH
from pathtracer_tpu.ops import intersect
from pathtracer_tpu.scene.scene import Scene


class FatNodes(NamedTuple):
    """Fused traversal table, (2n,) rows (last row = DONE dummy)."""
    fdata: jnp.ndarray  # (2n, 16) f32: bmin(3) bmax(3) v0(3) e1(3) e2(3) r(1)
    idata: jnp.ndarray  # (2n, 4) int32: left, escape, prim_type(0=internal), prim_id
    done: int           # sentinel index (= 2n-1)


def pack_fat_nodes(scene: Scene, bvh: LBVH) -> FatNodes:
    """Gather leaf primitive geometry into the node table."""
    num_nodes = bvh.num_nodes
    is_leaf = bvh.obj_id >= 0
    pid = jnp.clip(bvh.obj_id, 0, scene.num_prims - 1)
    v0 = jnp.take(scene.v0, pid, axis=0)
    e1 = jnp.take(scene.e1, pid, axis=0)
    e2 = jnp.take(scene.e2, pid, axis=0)
    radius = jnp.take(scene.radius, pid, axis=0)
    ptype = jnp.where(is_leaf, jnp.take(scene.prim_type, pid, axis=0), 0)

    fdata = jnp.concatenate([
        bvh.box_min, bvh.box_max, v0, e1, e2, radius[:, None]], axis=1)
    idata = jnp.stack([
        bvh.left, bvh.escape, ptype,
        jnp.where(is_leaf, bvh.obj_id, 0)], axis=1)

    # DONE dummy row: inverted box (never hits), escape -> itself.
    done = num_nodes
    big = jnp.float32(3e38)
    dummy_f = jnp.concatenate([
        jnp.full((1, 3), big), jnp.full((1, 3), -big),
        jnp.zeros((1, 9)), jnp.ones((1, 1))], axis=1).astype(jnp.float32)
    dummy_i = jnp.array([[done, done, 0, 0]], jnp.int32)
    return FatNodes(fdata=jnp.concatenate([fdata, dummy_f], axis=0),
                    idata=jnp.concatenate([idata, dummy_i], axis=0),
                    done=done)


def traverse(nodes: FatNodes, o, d, t_min, t_max, max_steps: int = 0,
             with_steps: bool = False) -> Tuple[jnp.ndarray, ...]:
    """Closest-hit query for a batch of rays.

    Returns (prim_idx (R,) int32, t (R,), valid (R,) bool), plus the loop's
    step count when ``with_steps``: the wavefront steps until its slowest
    ray is done, and each step is one while-loop iteration whose predicate
    the host reads back. ``max_steps`` bounds the batched loop (default
    4 * node count — a malformed-tree guard; a correct DFS visits each node
    at most once per ray).
    """
    num_rows = nodes.fdata.shape[0]
    done = nodes.done
    if max_steps <= 0:
        max_steps = 4 * num_rows
    r = o.shape[0]

    def cond(state):
        ptr, _, _, steps = state
        return (steps < max_steps) & jnp.any(ptr != done)

    def body(state):
        ptr, t_best, best, steps = state
        frow = jnp.take(nodes.fdata, ptr, axis=0)
        irow = jnp.take(nodes.idata, ptr, axis=0)
        bmin, bmax = frow[:, 0:3], frow[:, 3:6]
        v0, e1, e2 = frow[:, 6:9], frow[:, 9:12], frow[:, 12:15]
        radius = frow[:, 15]
        left, escape = irow[:, 0], irow[:, 1]
        ptype, prim_id = irow[:, 2], irow[:, 3]

        # prune against the current closest hit (render_manager.h:106,120)
        box_hit = intersect.ray_aabb_hit(o, d, bmin, bmax, t_min, t_best)
        is_leaf = ptype > 0

        hit, t = intersect.intersect_prims(
            o, d, ptype, v0, e1, e2, radius, t_min, t_best)
        better = box_hit & is_leaf & hit & (t < t_best)
        t_best = jnp.where(better, t, t_best)
        best = jnp.where(better, prim_id, best)

        ptr = jnp.where(box_hit & ~is_leaf, left, escape)
        return ptr, t_best, best, steps + 1

    ptr0 = jnp.zeros(r, jnp.int32)
    t0 = jnp.full(r, t_max, jnp.float32)
    best0 = jnp.full(r, -1, jnp.int32)
    _, t_best, best, steps = jax.lax.while_loop(
        cond, body, (ptr0, t0, best0, jnp.int32(0)))
    valid = best >= 0
    out = (jnp.where(valid, best, 0), t_best, valid)
    return out + (steps,) if with_steps else out


def make_bvh_closest_hit(scene: Scene, bvh: LBVH, t_min: float):
    """Closest-hit factory for the integrator. The node table is detached:
    visibility is non-differentiable by design."""
    nodes = jax.tree_util.tree_map(
        lambda x: jax.lax.stop_gradient(x) if hasattr(x, "dtype") else x,
        pack_fat_nodes(scene, bvh))

    def closest(o, d):
        return traverse(nodes, o, d, jnp.float32(t_min),
                        jnp.float32(intersect.BIG_T))
    return closest
