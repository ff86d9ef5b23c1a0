"""The persistent compilation cache location (tpu2048.compile_cache)."""

import jax
import pytest

from tpu2048 import compile_cache


@pytest.fixture
def cache_config(monkeypatch):
    """Restore the process's cache setting after the test."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_honoured_and_left_alone(cache_config, monkeypatch,
                                            tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_default_is_fixed_dir_in_checkout(cache_config):
    got = compile_cache.setup_compile_cache()
    assert got == str(compile_cache.DEFAULT_DIR)
    assert jax.config.jax_compilation_cache_dir == got
    assert compile_cache.DEFAULT_DIR.name == ".jax_cache"
    assert (compile_cache.DEFAULT_DIR.parent / "tpu2048").is_dir()
    # the same path on every call: it is part of the cache key
    assert compile_cache.setup_compile_cache() == got


def test_existing_setting_is_not_overridden(cache_config, tmp_path):
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)
