"""Persistent compile cache placement (utils/compile_cache.py)."""

import os

import jax
import pytest

from rome_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_enable_follows_env_dir(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path)
    # JAX reads the variable itself; enable() sets no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_enable_defaults_to_ignored_dir_in_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    with open(os.path.join(root, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
