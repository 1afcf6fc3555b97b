"""JAX's persistent compilation cache, kept at one fixed place.

A compiled tick takes tens of seconds to build on the GPU; the cache keeps
it across processes. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads
it itself and nothing is changed here. Otherwise the cache goes to
``<repo>/.jax_cache`` (listed in ``.gitignore``): a fixed path, because the
path is part of what a later process looks up.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
