"""Profiling + compilation-cache helpers (the reference has neither,
SURVEY.md §5 tracing)."""

from __future__ import annotations

import contextlib
import os

# Fixed, so that every process of a checkout finds the same entries: the
# cache directory is part of what JAX keys a compiled program by.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


@contextlib.contextmanager
def step_annotation(name: str, step: int):
    """jax.profiler step annotation — visible in TensorBoard/XProf traces."""
    import jax

    with jax.profiler.StepTraceAnnotation(name, step_num=step):
        yield


def enable_compilation_cache() -> None:
    """Persist XLA compilations across processes.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself (an
    empty value turns the cache off) and nothing is set here. Otherwise the
    cache lives at ``<checkout>/.jax_cache``."""
    if "JAX_COMPILATION_CACHE_DIR" in os.environ:
        return
    import jax

    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)

