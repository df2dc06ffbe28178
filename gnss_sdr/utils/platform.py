"""The two platforms the receiver runs on, and where compiled code lives.

``cpu`` is the test and reference platform: Pallas kernels run in
interpret mode there. ``gpu`` compiles them. Any other platform is an
error, never a silent fallback.
"""
from __future__ import annotations

import os
import pathlib

import jax

SUPPORTED = ("cpu", "gpu")
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# fixed, so the cache key (which includes the path) hits across runs;
# listed in .gitignore
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def backend() -> str:
    """``jax.default_backend()``, checked against the supported set."""
    name = jax.default_backend()
    if name not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}: the receiver runs on "
            f"{' or '.join(SUPPORTED)}")
    return name


def interpret_kernels() -> bool:
    """Pallas kernels run interpreted on the CPU and compiled on a GPU."""
    return backend() == "cpu"


def compile_cache_dir(environ=None) -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else the in-checkout
    ``.jax_cache``."""
    env = os.environ if environ is None else environ
    return env.get(CACHE_ENV) or str(DEFAULT_CACHE_DIR)


def enable_compile_cache() -> str | None:
    """Persist compiled GPU programs across processes.

    JAX itself reads ``$JAX_COMPILATION_CACHE_DIR``; only when that is
    unset (and nothing configured a directory) is the fixed path set
    here. CPU programs compile in seconds and are not cached. Returns
    the directory in use, or None."""
    if backend() == "cpu":
        return None
    if jax.config.jax_compilation_cache_dir is None:
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    return jax.config.jax_compilation_cache_dir
