"""The persistent compilation cache helper (bundle_adjustment_tpu/
compile_cache.py): JAX_COMPILATION_CACHE_DIR wins; otherwise one fixed
directory in the checkout, whatever the working directory."""

import os

import jax

from bundle_adjustment_tpu import compile_cache


def test_env_dir_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable() == str(tmp_path)
        # JAX reads the variable itself; the helper sets no other directory
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def test_default_dir_is_in_checkout_whatever_the_cwd(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        compile_cache.__file__)))
    expected = os.path.join(root, ".jax_cache")
    assert compile_cache.cache_dir() == expected
    monkeypatch.chdir(tmp_path)
    assert compile_cache.cache_dir() == expected
    assert os.path.isfile(os.path.join(root, "chip_smoke.py"))
