"""The persistent compile cache's placement (config.enable_compilation_cache).

Each test restores JAX's cache settings and compiles nothing while they
are changed, so no other test ever uses the cache."""

import os

import jax
import pytest

from fastdnn_tpu import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def cache_settings():
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    old = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in old.items():
        jax.config.update(k, v)


def test_default_dir_is_fixed_inside_the_checkout():
    assert config.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")


def test_default_used_when_nothing_is_set(cache_settings, monkeypatch, tmp_path):
    target = str(tmp_path / "cache")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("FASTDNN_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(config, "DEFAULT_CACHE_DIR", target)
    config.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == target
    assert os.path.isdir(target)


@pytest.mark.parametrize(
    "env",
    [{"JAX_COMPILATION_CACHE_DIR": "/nonexistent/jax-cache"}, {"FASTDNN_COMPILE_CACHE": "0"}],
    ids=["jax-env-dir-wins", "off-switch"],
)
def test_env_leaves_jax_config_alone(cache_settings, monkeypatch, tmp_path, env):
    for k in ("JAX_COMPILATION_CACHE_DIR", "FASTDNN_COMPILE_CACHE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(config, "DEFAULT_CACHE_DIR", str(tmp_path / "unused"))
    before = jax.config.jax_compilation_cache_dir
    config.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "unused").exists()
