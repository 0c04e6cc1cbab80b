"""Where compiled programs persist between processes: one rule for every
entry point (server, bench, smoke script).

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing is set
  in code.
* otherwise: a fixed directory inside the checkout (``<repo>/.jax_cache``,
  listed in ``.gitignore``). The path is part of the cache key, so it must
  not move between runs.

A server restart or a repeated bench run then reuses compiled programs
instead of paying seconds per graph signature again.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir(requested: Optional[str] = None) -> Optional[str]:
    """The directory the cache lives in, or None when it is off.

    ``requested``: None = the default rule above; "" = off; a path = that
    path. The environment variable wins over both."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    if requested is None:
        return DEFAULT_DIR
    return requested or None


def enable(requested: Optional[str] = None) -> Optional[str]:
    """Turn the persistent cache on per ``cache_dir``; returns the dir."""
    d = cache_dir(requested)
    if d is None or os.environ.get(ENV_VAR):
        return d
    import jax

    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    logger.info("compilation cache at %s", d)
    return d
