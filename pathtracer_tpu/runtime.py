"""Process set-up shared by the CLI, the benchmarks and ``chip_smoke.py``:
the persistent compile cache and the device every result names."""
from __future__ import annotations

import os
import subprocess

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Use JAX's persistent compilation cache; call before the first compile.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    itself) and nothing else is set. Otherwise the cache lives at the fixed
    path ``<checkout>/.jax_cache``: the path is part of the cache key, so a
    directory that moved would never hit. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_info() -> dict:
    """The device results are reported for, as JAX names it."""
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def require_gpu(what: str) -> None:
    """Raise unless JAX's default device is a GPU: a measurement path never
    falls back to the CPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(f"{what}: no GPU (JAX platform "
                           f"{info['platform']!r}) — not measured")


def gpu_name_and_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one line
    each, or a note why it could not be read. A card set below its maximum
    power runs slower under load, so this goes beside every number."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    if out.returncode != 0:
        return f"nvidia-smi failed (rc {out.returncode})"
    return out.stdout.strip()
