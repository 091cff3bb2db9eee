"""The persistent compile cache: the environment variable wins; otherwise
a fixed directory inside the checkout, whatever the working directory."""

import os
import subprocess
import sys

import jax
import pytest

from topicmodelsvb_jl_tpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_left_to_jax(monkeypatch, restore_cache_dir):
    monkeypatch.setenv(cache.ENV, "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache(platform="gpu") == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_default_dir_is_inside_the_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(cache.ENV, raising=False)
    got = cache.enable_compile_cache(platform="gpu")
    assert got == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_no_cache_on_cpu(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(cache.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache(platform="cpu") is None
    assert jax.config.jax_compilation_cache_dir == before


def test_default_dir_stable_across_cwd(tmp_path):
    code = ("from topicmodelsvb_jl_tpu.utils import cache; "
            "print(cache.DEFAULT_DIR)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout.strip()
    assert out == os.path.join(ROOT, ".jax_cache")
