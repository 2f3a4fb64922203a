"""Profiler tracing.

The reference's tracing is manual chrono brackets (SURVEY.md §5); the JAX
equivalent is an XLA profiler trace viewable in TensorBoard/Perfetto —
per-kernel device times, HBM traffic, and pipeline occupancy come from the
trace, not wall clocks.

Usage::

    with trace("/tmp/tpuspmm-trace"):
        C = tpuspmm.spmm(A, B)

or via the CLI: ``python -m tpuspmm.cli --csr -d DIR --trace /tmp/trace``.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (no-op if the profiler is unavailable)."""
    import jax

    started = False
    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception:
        pass
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass
