"""Format-selection engine.

The reference's engine family dispatches within one user-chosen format; the
north-star capability (BASELINE.json) adds automatic selection: inspect the
sparsity pattern and pick the (format, kernel) pair.  The rules follow the
dispatch thresholds measured on the card (kernels/dispatch.py):

- real block structure (well-filled 4×4 blocks) → BSR, else CSR, with:
- the block-sparse kernel's tiles filled and its grid large enough to
  fill the card (kernels/dispatch.blocksparse_pays) → the Triton
  block-sparse kernel;
- dense enough, with an affordable dense A → densify + cuBLAS;
- low row-length variance with small max ⇒ ELL-friendly padding, gather
  + segment-sum;
- otherwise (hyper-sparse, irregular) → CSR gather + segment-sum.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SparsityStats:
    shape: Tuple[int, int]
    nnz: int
    density: float
    row_nnz_mean: float
    row_nnz_max: int
    row_nnz_cv: float  # coefficient of variation (imbalance)
    block_fill_4x4: float  # nnz density within nonempty (4, 4) blocks


def analyze(a) -> SparsityStats:
    coo = a if a.format_name == "coo" else (a.to_coo() if hasattr(a, "to_coo") else a.to_csr().to_coo())
    r = np.asarray(coo.rows, dtype=np.int64)
    c = np.asarray(coo.cols, dtype=np.int64)
    m, k = coo.shape
    nnz = len(r)
    row_counts = np.bincount(r, minlength=m)
    mean = row_counts.mean() if m else 0.0
    cv = float(row_counts.std() / mean) if mean > 0 else 0.0

    def block_stats(bh, bw):
        ids = (r // bh) * (-(-k // bw)) + (c // bw)
        nonempty = len(np.unique(ids))
        cap = nonempty * bh * bw
        return nonempty, (nnz / cap if cap else 0.0)

    _, fill4 = block_stats(4, 4)

    return SparsityStats(
        shape=(m, k), nnz=nnz, density=nnz / (m * k) if m * k else 0.0,
        row_nnz_mean=float(mean), row_nnz_max=int(row_counts.max()) if m else 0,
        row_nnz_cv=cv, block_fill_4x4=float(fill4),
    )


def select_format(a, n_width: int = 256) -> Tuple[str, str]:
    """Return (format, kernel_name) recommendation for this matrix."""
    from tpuspmm.engine.registry import gather_fits
    from tpuspmm.kernels.dispatch import blocksparse_pays, thresholds

    stats = analyze(a)
    th = thresholds()
    # real block structure keeps its blocks: BSR whatever the kernel
    fmt = "bsr" if stats.block_fill_4x4 > 0.5 else "csr"
    if blocksparse_pays(a, n_width):
        return fmt, "triton_blocksparse"
    if (stats.density >= th["densify_min_density"]
            and stats.shape[0] * stats.shape[1] * 4
            <= th["densify_max_bytes"]):
        return fmt, "xla_densify_matmul"
    if fmt == "bsr":
        return "bsr", "xla_block_einsum"
    if (stats.row_nnz_cv < 0.5
            and stats.row_nnz_max <= 4 * max(stats.row_nnz_mean, 1.0)
            and gather_fits(a, n_width)):
        return "ell", "xla_segment_sum"
    return "csr", "xla_segment_sum"


def auto_spmm(a, b, config=None):
    """Select and run: the engine-of-engines entry point."""
    from tpuspmm.formats import convert
    from tpuspmm.engine.registry import get_engine
    from tpuspmm.config import default_config

    config = config or default_config()
    n_width = int(np.shape(b)[1])
    fmt, kernel_name = select_format(a, n_width=n_width)
    if a.format_name != fmt:
        a = convert.to_format(a, fmt)
    engine = get_engine(fmt)
    variant = next(v for v in engine.variants if v.name == kernel_name)
    if variant.inadmissible_reason(a, b, config):
        # recommendation inadmissible for this operand — serve the
        # dispatcher's route rather than crash
        from tpuspmm.kernels import dispatch

        return dispatch.spmm_auto(a, b, config), fmt, "dispatch"
    return variant.fn(a, b, config), fmt, kernel_name
