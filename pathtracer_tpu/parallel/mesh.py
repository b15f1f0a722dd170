"""Device mesh construction + multi-host bring-up.

Replaces the reference's absent distributed story (SURVEY §2.3 bottom rows):
``jax.distributed.initialize`` for multi-host process groups, then one
``jax.sharding.Mesh`` over the devices. Two logical axes:

- ``rays``: data parallelism over the pixel/ray wavefront — each device owns a
  contiguous shard of the flattened framebuffer (the analogue of the
  reference's 2-D thread grid, main.cu:275-280).
- ``spp``: sample parallelism — the per-thread spp loop (main.cu:283-289)
  split across devices, combined with one ``psum`` over the axis.

Scene, BVH and camera are replicated (one-time broadcast), so all steady-state
collective traffic is the spp-axis psum + the final framebuffer gather.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh

RAYS_AXIS = "rays"
SPP_AXIS = "spp"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (no-op single-process).

    Thin wrapper over ``jax.distributed.initialize`` so launchers have one
    entry point; on a single host (or when already initialized) it is safe to
    call and does nothing. MUST run before any JAX computation touches the
    backend (even building a jnp constant initializes it) — call this before
    importing renderer modules (see tests/distributed_worker.py).
    """
    if num_processes is None or num_processes <= 1:
        return
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError:
        if jax.process_count() == num_processes:
            return  # already initialized with the right topology
        raise


def make_mesh(devices: Optional[Sequence] = None,
              spp_axis_size: int = 1) -> Mesh:
    """Build the (rays, spp) mesh over all (or the given) devices.

    ``spp_axis_size`` devices cooperate on samples for the same pixels; the
    remaining factor shards pixels. Default 1: pure ray data-parallelism —
    rays are embarrassingly parallel, so this is the right default until spp
    is large enough that per-device sample batches go underutilized
    (the BASELINE 512-spp config).
    """
    if devices is None:
        devices = jax.devices()
    dev_arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        dev_arr[i] = d
    devices = dev_arr
    n = devices.size
    if n % spp_axis_size != 0:
        raise ValueError(f"{n} devices not divisible by spp_axis_size="
                         f"{spp_axis_size}")
    grid = devices.reshape(n // spp_axis_size, spp_axis_size)
    return Mesh(grid, (RAYS_AXIS, SPP_AXIS))
