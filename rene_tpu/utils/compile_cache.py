"""Placement of JAX's persistent compilation cache.

The cache's directory is part of its key, so it has to be one fixed path:
`JAX_COMPILATION_CACHE_DIR` when the environment sets it (JAX reads that
variable itself), otherwise `<repo>/.jax_cache` in the checkout. Call
`enable_compile_cache()` before the first compile; setting the environment
variable from code after JAX has been imported has no effect.
"""
from __future__ import annotations

import os
from typing import Mapping, Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache(environ: Optional[Mapping[str, str]] = None) -> str:
    """Point JAX's persistent compilation cache at its fixed directory and
    return that directory. An environment that names one wins, and then
    nothing is changed."""
    environ = os.environ if environ is None else environ
    if environ.get(ENV_VAR):
        return environ[ENV_VAR]
    import jax
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
