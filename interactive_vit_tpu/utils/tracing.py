"""Tracing, profiling, and numeric sanitizers.

The reference's observability was console DEBUG narration (SURVEY.md §5).
Device-aware replacements:

* ``trace(dir)`` — jax.profiler Perfetto traces; the executor wraps every
  node in ``jax.named_scope("n<i>_<kind>")`` so XLA trace events map back to
  graph nodes;
* ``profiler_server(port)`` — live-attach endpoint for profile capture;
* ``debug_nans(on)`` — the numeric sanitizer (jit re-runs op-by-op on NaN
  and raises at the producing op), the role a race/memory sanitizer plays
  in a native stack;
* ``node_timings(executor, graph)`` — per-node wall-times via the eager
  debug path, for the "which layer is slow" interactive question.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import jax


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a profiler trace of the enclosed block into ``log_dir``."""
    jax.profiler.start_trace(log_dir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def profiler_server(port: int = 9999):
    """Start the live jax profiler server (attach with TensorBoard/XProf)."""
    return jax.profiler.start_server(port)


def debug_nans(on: bool = True) -> None:
    """Toggle jax's NaN debugger (``jax.config.debug_nans``)."""
    jax.config.update("jax_debug_nans", on)


def node_timings(executor, graph) -> Dict[int, float]:
    """Per-node wall-times (seconds). Debug path: unfused, per-node jit.

    Delegates to ``Executor.run_timed_eager`` (the ``/debug_eval``
    engine): per-node jit instead of op-by-op eager (catastrophic through
    a remote backend), with the "eval error upstream" fault-isolation
    contract — one failing node doesn't lose every timing."""
    timings_ms, _, _ = executor.run_timed_eager(graph)
    return {i: ms / 1e3 for i, ms in timings_ms.items()}
