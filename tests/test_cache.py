"""utils/cache.py: JAX_COMPILATION_CACHE_DIR wins when set; otherwise one
fixed, gitignored directory inside the checkout."""

import os

import jax
import pytest

from pde_inverse.utils import cache


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_set_sets_no_directory(monkeypatch, restore_cache_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "from_env"))
    monkeypatch.delenv("PDE_INVERSE_NO_CACHE", raising=False)
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    cache.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == "sentinel"
    assert not (tmp_path / "from_env").exists()


def test_env_var_unset_uses_fixed_path_in_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("PDE_INVERSE_NO_CACHE", raising=False)
    cache.enable_compilation_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jax.config.jax_compilation_cache_dir == os.path.join(repo, ".jax_cache")
    assert os.path.isdir(cache.CACHE_DIR)
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_opt_out(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("PDE_INVERSE_NO_CACHE", "1")
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    cache.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == "sentinel"
