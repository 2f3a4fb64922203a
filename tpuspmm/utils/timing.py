"""The one timer of tpuspmm.

A warm-up call (compilation, caches, transfers), then the median over
``repeats`` of one call followed by ``jax.block_until_ready`` — on a CUDA
device the wait really synchronises, as the reference's
launch + cudaDeviceSynchronize bracket does
(reference/src/spmm/csr/spmm_csr_k2.cu:71-96).  A call that raises makes
the measurement raise; nothing falls back to another clock.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import numpy as np


def time_ms(fn: Callable, warmup: int = 1, repeats: int = 10
            ) -> Tuple[float, object]:
    """Median wall milliseconds of ``fn()`` to completion, and the last
    result."""
    import jax

    out = None
    for _ in range(max(0, warmup)):
        out = jax.block_until_ready(fn())
    times = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out
