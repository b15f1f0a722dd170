"""Checkpoint / resume between spp chunks.

The reference has no checkpointing — its only artifact is the final PNG
(SURVEY §5). Here rendering is resumable by construction: radiance
accumulation is a sum over sample indices and the RNG is stateless
(sample s of pixel p derives from fold(seed, s, pixel)), so a checkpoint is
just (accumulated framebuffer, next sample index, config fingerprint).
Killing the render at any chunk boundary and resuming produces the
bit-identical final image (elastic-recovery story: fail-fast per process +
cheap resume).

Also provides optimizer-state checkpointing for the inverse-rendering fit
(render/diff.py) via the same npz container.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import tempfile
from typing import Optional, Tuple

import numpy as np

from pathtracer_tpu.config import RenderConfig

FORMAT_VERSION = 1


def _cfg_fingerprint(cfg: RenderConfig, scene_nprims: int) -> str:
    """Stable hash of everything that must match for a resume to be valid."""
    payload = json.dumps({
        "v": FORMAT_VERSION,
        "cfg": dataclasses.asdict(cfg),
        "n_prims": scene_nprims,
    }, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _atomic_save(path: str, **arrays) -> None:
    """Write-then-rename so a crash mid-save never corrupts the checkpoint."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_render_state(path: str, acc: np.ndarray, next_sample: int,
                      cfg: RenderConfig, scene_nprims: int) -> None:
    _atomic_save(path,
                 acc=np.asarray(acc, np.float32),
                 next_sample=np.int64(next_sample),
                 fingerprint=np.frombuffer(
                     _cfg_fingerprint(cfg, scene_nprims).encode(), np.uint8))


def load_render_state(path: str, cfg: RenderConfig,
                      scene_nprims: int) -> Optional[Tuple[np.ndarray, int]]:
    """Load (acc, next_sample) if the checkpoint matches; else None."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        fp = bytes(z["fingerprint"]).decode()
        if fp != _cfg_fingerprint(cfg, scene_nprims):
            return None
        return np.asarray(z["acc"]), int(z["next_sample"])


def render_with_checkpoints(scene, cam, cfg: RenderConfig,
                            path: Optional[str],
                            spp_per_chunk: int = 16, bvh=None,
                            progress=None) -> np.ndarray:
    """Render ``cfg.spp`` samples in resumable chunks.

    On each chunk boundary the accumulated framebuffer + next sample index
    are atomically checkpointed to ``path``; on start, a matching checkpoint
    is resumed from. The result is bit-identical to an uninterrupted render
    of the same config/seed because per-sample keys depend only on
    (seed, global sample index, pixel chunk) — see renderer.render_sum.

    ``path=None`` skips persistence but keeps the bounded-execution shape:
    each chunk is its own device program, so a multi-minute render never
    runs as one monolithic execution (progress, resumability, and no
    single device program that runs for minutes).

    Returns the gamma-2 image (H, W, 3) float32.
    """
    import jax
    import jax.numpy as jnp

    from pathtracer_tpu.render import renderer as renderer_mod

    if cfg.accel == "bvh" and bvh is None:
        from pathtracer_tpu.accel.lbvh import build_lbvh
        bvh = build_lbvh(scene)
    if cfg.accel != "bvh":
        bvh = None

    n_pixels = cfg.num_pixels
    chunk = min(cfg.ray_chunk, n_pixels)
    rows0, cols0 = renderer_mod.padded_pixel_grid(cfg, chunk)
    n_padded = rows0.shape[0]

    state = (load_render_state(path, cfg, scene.num_prims)
             if path is not None else None)
    if state is not None:
        acc_np, start = state
        assert acc_np.shape == (n_padded, 3)
    else:
        acc_np, start = np.zeros((n_padded, 3), np.float32), 0

    cfg_local = cfg.replace(ray_chunk=chunk)
    base_key = jax.random.PRNGKey(cfg.seed)

    @functools.partial(jax.jit, static_argnames=("n",))
    def chunk_sum(acc, offset, n):
        return acc + renderer_mod.render_sum(
            scene, bvh, cam, base_key, rows0, cols0, cfg_local, n,
            sample_offset=offset)

    acc = jnp.asarray(acc_np)
    s = start
    while s < cfg.spp:
        n = min(spp_per_chunk, cfg.spp - s)
        acc = jax.block_until_ready(chunk_sum(acc, s, n))
        s += n
        if path is not None:
            save_render_state(path, np.asarray(acc), s, cfg,
                              scene.num_prims)
        if progress is not None:
            progress(s, cfg.spp)

    img = np.sqrt(np.maximum(np.asarray(acc)[:n_pixels], 0.0) / cfg.spp)
    return img.reshape(cfg.height, cfg.width, 3)


# --- optimizer-state checkpointing for the inverse-rendering fit ---

def save_fit_state(path: str, params: dict, step: int,
                   loss_history) -> None:
    arrays = {f"param_{k}": np.asarray(v) for k, v in params.items()}
    _atomic_save(path, step=np.int64(step),
                 loss_history=np.asarray(loss_history, np.float64),
                 **arrays)


def load_fit_state(path: str) -> Optional[Tuple[dict, int, list]]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        params = {k[len("param_"):]: np.asarray(z[k])
                  for k in z.files if k.startswith("param_")}
        return params, int(z["step"]), list(z["loss_history"])


# --- optional Orbax backend for the fit loop -------------------------------
# The npz container above is the default (zero deps, atomic, fingerprinted).
# Production JAX deployments standardize on Orbax for sharded/async
# checkpointing of train state; this mirrors save/load_fit_state onto an
# orbax.checkpoint.PyTreeCheckpointer so the fit loop can slot into such a
# pipeline. Orbax is an optional import — absence degrades to ImportError
# only when these functions are actually called.

def save_fit_state_orbax(path: str, params: dict, step: int,
                         loss_history) -> None:
    """Orbax-backed save of the inverse-rendering fit state."""
    import orbax.checkpoint as ocp
    payload = {
        "params": {k: np.asarray(v) for k, v in params.items()},
        "step": np.int64(step),
        "loss_history": np.asarray(loss_history, np.float64),
    }
    ckpt = ocp.PyTreeCheckpointer()
    ckpt.save(os.path.abspath(path), payload, force=True)


def load_fit_state_orbax(path: str) -> Optional[Tuple[dict, int, list]]:
    """Orbax-backed load; returns (params, step, loss_history) or None."""
    import orbax.checkpoint as ocp
    if not os.path.exists(path):
        return None
    ckpt = ocp.PyTreeCheckpointer()
    payload = ckpt.restore(os.path.abspath(path))
    return (dict(payload["params"]), int(payload["step"]),
            list(payload["loss_history"]))
