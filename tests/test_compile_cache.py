"""Placement of the persistent compilation cache (utils/compile_cache.py)."""
import os

import jax
import pytest

from rene_tpu.utils import compile_cache as C


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_environment_wins_and_config_is_left_alone(restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    got = C.enable_compile_cache({C.ENV_VAR: "/some/where"})
    assert got == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_repo_directory_without_environment(restore_cache_dir):
    got = C.enable_compile_cache({})
    assert got == C.REPO_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == C.REPO_CACHE_DIR
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert C.REPO_CACHE_DIR == os.path.join(root, ".jax_cache")


def test_empty_environment_value_falls_back(restore_cache_dir):
    assert C.enable_compile_cache({C.ENV_VAR: ""}) == C.REPO_CACHE_DIR


def test_cache_directory_is_git_ignored():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, ".gitignore")) as f:
        lines = {ln.strip() for ln in f}
    assert ".jax_cache/" in lines
