"""Multi-device / multi-host parallelism.

The reference is single-process, single-GPU (SURVEY §2.3); its only
"communication" is cudaMemcpy H2D/D2H. This package is the
distributed backend SURVEY §5 calls for: a device mesh over the ray
wavefront, scene + BVH replicated, shard_map-sharded rendering with XLA
collectives, and psum gradient all-reduce for the inverse-rendering path.
"""
from pathtracer_tpu.parallel.mesh import (RAYS_AXIS, SPP_AXIS, make_mesh,
                                          initialize_distributed)

__all__ = [
    "RAYS_AXIS", "SPP_AXIS", "make_mesh", "initialize_distributed",
    "make_sharded_renderer", "sharded_render_image",
]


def __getattr__(name):
    # Lazy: importing the sharded renderer builds jnp constants, which
    # initializes the JAX backend — that must not happen as a side effect
    # of reaching initialize_distributed (multi-host bring-up must precede
    # the first backend touch; see mesh.initialize_distributed).
    if name in ("make_sharded_renderer", "sharded_render_image"):
        from pathtracer_tpu.parallel import sharded
        return getattr(sharded, name)
    raise AttributeError(name)
