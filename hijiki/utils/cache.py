"""Persistent XLA compilation cache.

The reference recompiles its GLSL in well under a second (shaderc,
src/main.rs:715-751); XLA compiles of a 1024^2 sweep take seconds to
minutes. jax's persistent compilation cache lets a repeat invocation with the
same shapes and scene statics skip them.

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says; jax reads that
variable itself, and this module then sets no other directory. Without it the
cache sits at a fixed directory inside the checkout (``.jax_cache``, listed in
.gitignore): the path is part of what a later run must find again, so it must
not move between runs.
"""

from __future__ import annotations

import logging
import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache uses on an accelerator."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> str | None:
    """Turn the persistent cache on for an accelerator backend; returns the
    directory, or None on the CPU.

    The CPU stays uncached: XLA:CPU deserializes cached executables with a
    loader that warns on machine-feature drift and has crashed the test suite
    mid-read, and CPU compiles are short anyway.
    """
    if jax.default_backend() == "cpu":
        return None
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


class CacheCounter(logging.Handler):
    """Counts persistent-cache hits and misses from jax's compiler log.

    ``attach()`` raises that logger to DEBUG (where jax reports every lookup)
    and stops it from propagating, so the lookups reach only this handler."""

    def __init__(self) -> None:
        super().__init__(logging.DEBUG)
        self.hits = 0
        self.misses = 0

    def emit(self, record: logging.LogRecord) -> None:
        msg = record.getMessage()
        if msg.startswith("Persistent compilation cache hit"):
            self.hits += 1
        elif msg.startswith("PERSISTENT COMPILATION CACHE MISS"):
            self.misses += 1

    def attach(self) -> "CacheCounter":
        log = logging.getLogger("jax._src.compiler")
        log.setLevel(logging.DEBUG)
        log.propagate = False
        log.addHandler(self)
        return self
