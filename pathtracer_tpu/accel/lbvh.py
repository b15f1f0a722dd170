"""On-device LBVH construction (Karras 2012).

On-device rebuild of the reference's hybrid host/device LBVH
(``utils/bvh.h:132-145``): morton codes + sort + topology emit + bbox fit all
run as one jitted XLA computation. Differences by design (SURVEY §5/§7):

- the sort is ``jax.lax.sort`` on device (the reference std::stable_sorts on
  the host, morton_code.h:71-73),
- ``determineRange``/``findSplit`` (bvh.h:17-69) become vectorized
  fixed-trip-count loops over all internal nodes at once — no cross-block
  ``__syncthreads`` hazard (bvh.h:87,110-113),
- bbox fitting is level-synchronized bottom-up sweeps, eliminating both
  growBBox defects: the unsynchronized sibling reads and the union into a
  default (0,0,0) box that inflated every internal AABB to contain the
  origin (bvh.h:117-130 + bvh_node.h defaults),
- a threaded ``escape`` index per node enables stackless traversal
  (replacing the per-thread 64-slot stack, render_manager.h:100-103).

Node array layout matches the reference (bvh.h:76-85): internal nodes at
[0, n-2], leaves at [n-1, 2n-2]; leaf <=> obj_id != -1 (bvh_node.h:8-17).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pathtracer_tpu.ops import morton
from pathtracer_tpu.scene.scene import Scene

# A Karras tree over 64-bit keys (32-bit code + 32-bit id tiebreak) has
# common-prefix length strictly increasing along any root->leaf path, so
# depth <= 65; fixed sweep counts below are chosen to cover that.
MAX_DEPTH_SWEEPS = 66
SEARCH_BITS = 32  # covers n up to 2^32 in the range/split searches


class LBVH(NamedTuple):
    """SoA node arrays, length 2n-1 (+ traversal thread links)."""
    box_min: jnp.ndarray   # (2n-1, 3)
    box_max: jnp.ndarray   # (2n-1, 3)
    left: jnp.ndarray      # (2n-1,) int32, -1 for leaves
    right: jnp.ndarray     # (2n-1,) int32, -1 for leaves
    parent: jnp.ndarray    # (2n-1,) int32, -1 for root
    obj_id: jnp.ndarray    # (2n-1,) int32, primitive id for leaves else -1
    escape: jnp.ndarray    # (2n-1,) int32 threaded miss link; 2n-1 = done

    @property
    def num_nodes(self) -> int:
        return self.box_min.shape[0]

    @property
    def num_leaves(self) -> int:
        return (self.num_nodes + 1) // 2


@partial(jax.jit, static_argnames=())
def build_lbvh(scene: Scene) -> LBVH:
    """Build the LBVH for a scene's primitive AABBs on device."""
    n = scene.num_prims
    centers = 0.5 * (scene.box_min + scene.box_max)  # aabb.h getCenter
    codes = morton.morton3d(centers, scene.world_min, scene.world_max)
    ids = jnp.arange(n, dtype=jnp.int32)
    # Stable sort by code; ids tie-break ascending — matching the
    # reference's stable_sort + id-in-low-bits union (morton_code.h:64-75).
    codes_s, ids_s = jax.lax.sort((codes, ids), dimension=0, num_keys=1,
                                  is_stable=True)

    def delta_idx(i, j):
        """Common-prefix length between sorted keys i and j; -1 out of
        range (morton_code.h:47-52)."""
        valid = (j >= 0) & (j < n) & (i >= 0) & (i < n)
        jc = jnp.clip(j, 0, n - 1)
        ic = jnp.clip(i, 0, n - 1)
        d = morton.clz64_pair(codes_s[ic], ids_s[ic], codes_s[jc], ids_s[jc])
        return jnp.where(valid, d, -1)

    num_internal = max(n - 1, 1)  # keep shapes static; masked when n == 1
    i_arr = jnp.arange(num_internal, dtype=jnp.int32)

    # --- determineRange (bvh.h:17-40), vectorized over all internal nodes.
    d_left = delta_idx(i_arr, i_arr - 1)
    d_right = delta_idx(i_arr, i_arr + 1)
    direction = jnp.sign(d_right - d_left).astype(jnp.int32)
    min_delta = jnp.minimum(d_left, d_right)

    # exponential search: double maxStride while delta stays > min_delta
    def grow(_, stride):
        return jnp.where(delta_idx(i_arr, i_arr + stride * direction)
                         > min_delta, stride * 2, stride)
    max_stride = jax.lax.fori_loop(0, SEARCH_BITS, grow,
                                   jnp.full_like(i_arr, 2))

    # binary descent for the exact range length l
    def descend(_, carry):
        l, cur = carry
        take_step = (cur >= 1) & (delta_idx(
            i_arr, i_arr + (l + cur) * direction) > min_delta)
        return jnp.where(take_step, l + cur, l), cur >> 1

    l, _ = jax.lax.fori_loop(0, SEARCH_BITS, descend,
                             (jnp.zeros_like(i_arr), max_stride >> 1))
    j_arr = i_arr + l * direction
    first = jnp.minimum(i_arr, j_arr)
    last = jnp.maximum(i_arr, j_arr)

    # --- findSplit (bvh.h:42-69): highest-differing-bit binary search.
    common_prefix = delta_idx(first, last)

    def split_step(carry, _):
        split, step, done = carry
        step = (step + 1) >> 1
        new_split = split + step
        ok = (new_split < last) & (delta_idx(first, new_split) > common_prefix)
        split = jnp.where(~done & ok, new_split, split)
        new_done = done | (step <= 1)
        return (split, step, new_done), None

    (split, _, _), _ = jax.lax.scan(
        split_step,
        (first, last - first, first == last),
        None, length=SEARCH_BITS)
    split = jnp.where(first == last, (first + last) >> 1, split)

    # --- children mapping (bvh.h:97-102): a child is a leaf iff it sits at
    # the edge of the node's range.
    leaf_start = n - 1
    child_a = jnp.where(split == first, leaf_start + split, split)
    child_b = jnp.where(split + 1 == last, leaf_start + split + 1, split + 1)

    num_nodes = 2 * n - 1
    left = jnp.full(num_nodes, -1, jnp.int32)
    right = jnp.full(num_nodes, -1, jnp.int32)
    parent = jnp.full(num_nodes, -1, jnp.int32)
    obj_id = jnp.full(num_nodes, -1, jnp.int32)
    if n > 1:
        left = left.at[i_arr].set(child_a)
        right = right.at[i_arr].set(child_b)
        parent = parent.at[child_a].set(i_arr)
        parent = parent.at[child_b].set(i_arr)
    obj_id = obj_id.at[leaf_start + jnp.arange(n)].set(ids_s)

    # --- leaf boxes from primitives; internal boxes via level-synchronized
    # bottom-up sweeps (replaces racy growBBox, bvh.h:117-130).
    big = jnp.float32(3e38)
    box_min = jnp.full((num_nodes, 3), big, jnp.float32)
    box_max = jnp.full((num_nodes, 3), -big, jnp.float32)
    box_min = box_min.at[leaf_start + jnp.arange(n)].set(
        jnp.take(scene.box_min, ids_s, axis=0))
    box_max = box_max.at[leaf_start + jnp.arange(n)].set(
        jnp.take(scene.box_max, ids_s, axis=0))

    if n > 1:
        lc = child_a
        rc = child_b

        def sweep(_, boxes):
            bmin, bmax = boxes
            new_min = jnp.minimum(jnp.take(bmin, lc, axis=0),
                                  jnp.take(bmin, rc, axis=0))
            new_max = jnp.maximum(jnp.take(bmax, lc, axis=0),
                                  jnp.take(bmax, rc, axis=0))
            return bmin.at[i_arr].set(new_min), bmax.at[i_arr].set(new_max)

        box_min, box_max = jax.lax.fori_loop(
            0, MAX_DEPTH_SWEEPS, sweep, (box_min, box_max))

    # --- threaded escape links: escape(x) = right sibling of the lowest
    # left-child ancestor-or-self; none -> DONE sentinel (= num_nodes).
    done_sentinel = num_nodes

    def escape_step(_, carry):
        y, esc, resolved = carry
        p = jnp.take(parent, jnp.clip(y, 0, num_nodes - 1), axis=0)
        at_root = p < 0
        pl = jnp.take(left, jnp.clip(p, 0, num_nodes - 1), axis=0)
        pr = jnp.take(right, jnp.clip(p, 0, num_nodes - 1), axis=0)
        is_left = (~at_root) & (pl == y)
        esc = jnp.where(~resolved & is_left, pr, esc)
        resolved = resolved | at_root | is_left
        y = jnp.where(resolved, y, p)
        return y, esc, resolved

    node_ids = jnp.arange(num_nodes, dtype=jnp.int32)
    esc0 = jnp.full(num_nodes, done_sentinel, jnp.int32)
    _, escape, _ = jax.lax.fori_loop(
        0, MAX_DEPTH_SWEEPS, escape_step,
        (node_ids, esc0, jnp.zeros(num_nodes, bool)))

    return LBVH(box_min=box_min, box_max=box_max, left=left, right=right,
                parent=parent, obj_id=obj_id, escape=escape)
