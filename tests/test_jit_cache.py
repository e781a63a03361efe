"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR when set (and no
other directory), otherwise one fixed path inside the checkout."""

import os

import jax

from gabor_color_image_segmentation.utils import jit_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_is_a_fixed_path_in_the_checkout(monkeypatch):
    monkeypatch.delenv(jit_cache.ENV_VAR, raising=False)
    assert jit_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    assert jit_cache.enable_compilation_cache() == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == os.path.join(REPO, ".jax_cache")


def test_environment_variable_wins_and_is_left_alone(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(jit_cache.ENV_VAR, str(tmp_path))
    assert jit_cache.cache_dir() == str(tmp_path)
    assert jit_cache.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself; the module sets no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_default_cache_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
