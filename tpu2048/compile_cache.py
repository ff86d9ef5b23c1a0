"""Where JAX keeps its persistent compilation cache.

Every entry point (``bench.py``, ``chip_smoke.py``, the web server, the
CLI, ``scripts/train_flagship.py``) calls ``setup_compile_cache()``
before its first compile, so a process that recompiles the train step
at a geometry it has compiled before finds the executable on disk.
The directory is part of the cache's key, so it never comes from a
temp name, a pid or the clock.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# <checkout>/.jax_cache (listed in .gitignore)
DEFAULT_DIR = Path(__file__).resolve().parents[1] / ".jax_cache"


def setup_compile_cache() -> str:
    """Enable the persistent compilation cache; return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and
    is left alone; so is a directory this process already configured.
    Otherwise the cache goes to ``DEFAULT_DIR``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
