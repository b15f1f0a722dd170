"""Process set-up helpers (pathtracer_tpu/runtime.py)."""
import os

import jax

from pathtracer_tpu import runtime


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: used as it is, nothing else set."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_checkout_path(monkeypatch):
    """Unset: a fixed path inside the checkout (the path is part of the
    cache key, so it must not move between runs)."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = runtime.enable_compile_cache()
        assert path == os.path.join(runtime.CHECKOUT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_info_names_the_device():
    info = runtime.device_info()
    assert info == {"platform": jax.devices()[0].platform,
                    "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}
