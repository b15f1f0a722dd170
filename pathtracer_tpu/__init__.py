"""pathtracer_tpu — a differentiable Monte Carlo path tracer in JAX.

A from-scratch re-design of the capabilities of the reference CUDA/OpenGL path
tracer (Nablax/Path-Tracer-CUDA-OpenGL) as a JAX wavefront program, run on
NVIDIA GPUs:

- wavefront pipeline over SoA ray/primitive buffers (no megakernel, no
  per-thread stacks) — the bounce loop is a ``lax.scan``, shading is
  branch-free masked selection over material tables,
- on-device LBVH (Karras 2012) build: morton codes + ``lax.sort`` +
  vectorized topology emit + level-synchronized bbox fitting,
- stackless ("threaded") BVH traversal: one fat-node gather per step,
- stateless counter-based RNG (threefry) instead of per-pixel curand states,
- differentiable shading with detached-visibility estimators,
- multi-device scaling via ``jax.sharding.Mesh`` + ``shard_map`` over ray tiles
  with the scene/BVH replicated and gradient ``psum``.

Reference behavior citations use ``file:line`` into the reference CUDA
renderer's source tree.
"""

__version__ = "0.2.0"

from pathtracer_tpu.config import RenderConfig  # noqa: F401
