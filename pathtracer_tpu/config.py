"""Runtime configuration.

Replaces the reference's compile-time knobs (reference
``utils/global_variables.h:8-42`` and scene-selection macros
``utils/macros.h:8-13`` consumed at ``main.cu:428-446``) with a real runtime
config: a frozen dataclass usable as a jit-static argument, JSON round-trip,
and a CLI (see ``pathtracer_tpu/__main__.py``).
"""
from __future__ import annotations

import dataclasses
import json

# Reference defaults: utils/global_variables.h:24-31
K_ASPECT_RATIO = 16.0 / 9.0
K_FRAME_WIDTH = 800
K_FRAME_HEIGHT = int(K_FRAME_WIDTH / K_ASPECT_RATIO)  # 450
K_SPP = 100
K_MAX_DEPTH = 50
K_CAMERA_SPEED = 2.5  # utils/global_variables.h:36
K_T_MIN = 1e-3        # shadow epsilon, main.cu:27

# Parametric t_min for NEE *shadow* queries. Shadow segments are
# unnormalized (light at t == 1), so a query's t_min is a PROPORTIONAL
# ignore window (t_min x light-distance); self-intersection is instead
# prevented by an absolute normal offset of the segment origin
# (render/lights.direct_lighting), so the parametric window can be ~zero —
# K_T_MIN here would skip real occluders within ~1e-3 x dist of the origin
# (a contact-shadow light leak at Cornell scale).
K_SHADOW_T_MIN = 1e-7

ACCELS = ("auto", "tensor", "pallas", "bvh", "brute")


def resolve_accel(accel: str, platform: str = None) -> str:
    """Resolve accel="auto" to the measured-best structure; other values
    pass through.

    "auto" is the dense sweep at every scene size: the Triton kernel
    (ops/pallas_sweep.py) on a GPU, the XLA sweep (ops/tensor_sweep.py)
    elsewhere, since a Triton kernel compiles only for CUDA devices. The
    H100 crossover table in PERF.md (bench.py --accel tensor|pallas|bvh on
    random, triangle, bunny and bunny --subdivide 1/2/4, 405 to 925,699
    prims) found no crossover: the Triton sweep beat the LBVH traversal
    13-24x at every size both finished, and the traversal did not finish
    the 925,699-prim cell. ``platform`` defaults to JAX's default
    backend."""
    if accel != "auto":
        return accel
    if platform is None:
        import jax
        platform = jax.default_backend()
    return "pallas" if platform == "gpu" else "tensor"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration (hashable -> usable as jit static arg)."""

    width: int = K_FRAME_WIDTH
    height: int = K_FRAME_HEIGHT
    spp: int = K_SPP
    max_depth: int = K_MAX_DEPTH
    t_min: float = K_T_MIN

    # Background: the reference's only light is the sky gradient
    # (main.cu:34-36). Cornell-box style scenes use emissive area lights and a
    # black background instead.
    sky: bool = True

    # Next-event estimation: sample area lights directly at diffuse bounces
    # (render/lights.py). Needs emissive prims in the scene; essential for
    # the Cornell configs, off by default for reference parity.
    nee: bool = False

    # Stratified pixel sampling: jitter sample s within stratum s mod m^2 of
    # an m x m sub-pixel grid (m = floor(sqrt(spp))) instead of the
    # reference's uniform jitter (main.cu:284-285). Lower variance at equal
    # spp; off by default for reference parity / golden stability.
    stratify: bool = False

    # Pixel-filter sampler: "random" (the reference's uniform jitter,
    # main.cu:284-285; composes with ``stratify``) or "sobol"
    # (per-pixel Owen-scrambled (0,2)-sequence, core/sampling.sobol_owen_2d
    # — lower variance at equal spp; overrides ``stratify``).
    sampler: str = "random"

    # Russian-roulette path termination after ``rr_depth`` bounces, using
    # the reference's shipped-but-unused constants (continue prob 0.8,
    # survivor scale 1.25 — global_variables.h:38-41). Unbiased; cuts deep-
    # path cost at depth-50 defaults. Off by default for reference parity.
    rr: bool = False
    rr_depth: int = 3

    # Reference quirk (main.cu:26-36): rays that exhaust max_depth without a
    # miss still return sky * attenuation. ``terminate_black=True`` switches
    # to the physically-correct black termination.
    terminate_black: bool = False

    # Acceleration structure: "auto" (the default — resolves by scene
    # size via resolve_accel), "tensor" (dense sweep as XLA matmuls —
    # ops/tensor_sweep.py), "pallas" (the dense sweep fused into one Triton
    # kernel — ops/pallas_sweep.py; CUDA devices only), "bvh" (LBVH
    # stackless traversal — ops/traversal.py, the large-scene path), or
    # "brute" (linear scan over primitives — the reference's own fallback,
    # render_manager.h:71-84, kept as the correctness reference).
    accel: str = "auto"

    # Wavefront execution shape: rays are processed in fixed-size chunks so
    # the HBM working-set stays bounded (samples accumulate in host-level
    # passes — see utils/checkpoint.render_with_checkpoints).
    ray_chunk: int = 16384

    # RNG seed for the stateless threefry keys (replaces curand seeding at
    # main.cu:420-422).
    seed: int = 0

    # Scene name for the CLI (test / triangle / random / cornell / bunny).
    scene: str = "triangle"

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError("frame size must be positive")
        if self.accel not in ACCELS:
            raise ValueError(f"unknown accel {self.accel!r}")

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "RenderConfig":
        return RenderConfig(**json.loads(s))

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
