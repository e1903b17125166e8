"""utils/compile_cache.py: JAX_COMPILATION_CACHE_DIR wins; otherwise the
cache is <checkout>/.jax_cache, a fixed path."""

import os

import jax

from ringzk_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_in_the_checkout_and_stable(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable()
    assert path == os.path.join(REPO, ".jax_cache")
    assert path == compile_cache.default_dir() == compile_cache.enable()
    assert jax.config.jax_compilation_cache_dir == path
