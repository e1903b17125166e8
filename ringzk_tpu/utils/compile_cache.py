"""JAX's persistent compilation cache, at one fixed place per checkout.

The protocol programs are large and take seconds to minutes to compile, so
every entry point (scripts, tests, chip_smoke.py) enables the cache through
:func:`enable`:

* if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing
  is changed;
* otherwise the cache lives at ``<checkout>/.jax_cache``, found from this
  file's own location. The path is part of what makes an entry hit, so it
  is fixed: never a temporary name, a process id or a time.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_dir() -> str:
    """``<checkout>/.jax_cache`` (the directory that holds the package)."""
    return str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on; return the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    path = default_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
