"""Where the persistent XLA compilation cache lives.

One rule for every entry point (CLI, ``bench.py``, ``chip_smoke.py``, the
tools): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing is set here; otherwise the cache goes to ``.jax_cache`` at the root
of the checkout. The path is part of each entry's key, so it must never
come from a temporary name, a process id or the time.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its one place and
    return that directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    DEFAULT_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
