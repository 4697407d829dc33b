"""Small helpers (reference: src/utils.{h,cpp}) and typed errors.

The reference validates user input with bare ``assert``
(config.cpp:43-49) — which crashes without a message and vanishes
under ``python -O``.  Here user-facing validation raises these typed
exceptions with actionable messages instead.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

# Fixed persistent-cache path: the path is part of what a later run
# looks up, so it must not move between runs.
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


class ConfigError(ValueError):
    """Invalid fit configuration (bad JSON values, conflicting keys)."""


class FitError(RuntimeError):
    """A fit or statistics operation cannot proceed (degenerate
    likelihood space, malformed sample files, empty contours)."""


def nint(x: float) -> int:
    """Nearest integer, half away from zero (utils.h:33-38)."""
    return int(np.floor(x + 0.5)) if x >= 0 else int(np.ceil(x - 0.5))


def median(values: Sequence[float]) -> float:
    """Median (utils.h:76-90)."""
    return float(np.median(np.asarray(values)))


def configure_compile_cache() -> str:
    """Point XLA's persistent compilation cache at a fixed directory.

    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when it is set
    nothing changes.  Otherwise the cache goes to ``.jax_cache/`` at
    the root of the checkout, and every later run finds the programs
    earlier runs compiled.  Call before the first compilation.  Returns
    the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    return DEFAULT_COMPILE_CACHE
