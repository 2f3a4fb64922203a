"""Best-route dispatch (``spmm(method="auto")``, the same on every backend).

The runtime analogue of the reference's compile-time kernel numbering
(reference/include/engine/engine_csr.hpp:68-89):

  extreme |values| (exact.needs_compensated)   → compensated f32
  the block-sparse kernel can run, its plan
      fits, its fill ≥ blocksparse_min_fill
      and its grid ≥ blocksparse_min_programs  → Triton block-sparse
  density ≥ densify_min_density and
      dense A ≤ densify_max_bytes              → cached densify + cuBLAS
  density < gather_max_density and the
      gather intermediate fits                 → XLA gather + segment-sum
  otherwise                                    → cuSPARSE

The numbers are per device, keyed by the ``device_kind`` JAX reports, and
were measured on that card (PERF.md, "Findings": uniform density sweeps,
large_25605 and Llama-2-7B-shaped block-pruned weights).  A GPU the table
does not hold is an error; the ``cpu`` row exists for the tests, its
kernel grid floor scaled to their matrices.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpuspmm.formats import CSR, COO, BSR, ELL

_DEVICE_THRESHOLDS = {
    # H100 SXM (device time per call): the kernel's cost follows its
    # occupied tiles, not its fill, and it needs a full card: at 128
    # programs (4096², width 256) it lost to densify at every density
    # 0.1-20%, at 512 and 688 programs it won at every fill measured
    # (2-20%); densify ties cuSPARSE at 10% uniform density and loses
    # below it; the gather and cuSPARSE trade places below ~1%
    "NVIDIA H100 80GB HBM3": {"densify_max_bytes": 256 * 1024 * 1024,
                              "densify_min_density": 0.15,
                              "blocksparse_min_fill": 0.02,
                              "blocksparse_min_programs": 512,
                              "gather_max_density": 0.01},
    "cpu": {"densify_max_bytes": 128 * 1024 * 1024,
            "densify_min_density": 0.15,
            "blocksparse_min_fill": 0.02,
            "blocksparse_min_programs": 8,
            "gather_max_density": 0.01},
}


def thresholds() -> dict:
    """Dispatch thresholds of the current device."""
    from tpuspmm.config import device_kind, platform

    if platform() == "cpu":
        return _DEVICE_THRESHOLDS["cpu"]
    kind = device_kind()
    if kind not in _DEVICE_THRESHOLDS:
        raise KeyError(f"no dispatch thresholds measured for device "
                       f"{kind!r}; add a row to dispatch._DEVICE_THRESHOLDS")
    return _DEVICE_THRESHOLDS[kind]


def spmm_xla_any(a, b):
    """The XLA gather route of any container."""
    from tpuspmm.ops import xla

    if isinstance(a, CSR):
        return xla.spmm_csr_xla(a, b)
    if isinstance(a, COO):
        return xla.spmm_coo_xla(a, b)
    if isinstance(a, BSR):
        return xla.spmm_bsr_xla(a, b)
    if isinstance(a, ELL):
        return xla.spmm_ell_xla(a, b)
    if hasattr(a, "to_csr"):
        return xla.spmm_csr_xla(a.to_csr(), b)
    raise TypeError(type(a))


def blocksparse_pays(a, n: int, config=None) -> bool:
    """Should the block-sparse kernel serve ``a`` at width ``n``?  Decided
    from the plan's stats, so no tile is built for a matrix it does not
    serve."""
    from tpuspmm.config import default_config
    from tpuspmm.engine.registry import blocksparse_fits
    from tpuspmm.kernels import blocksparse_gpu as bs

    config = config or default_config()
    th = thresholds()
    return (bs.runnable(config.interpret)
            and bs.n_programs(a.shape[0], n) >= th["blocksparse_min_programs"]
            and bs.plan_stats(a).fill >= th["blocksparse_min_fill"]
            and blocksparse_fits(a))


def choose_route(a, n: int, config=None) -> str:
    """Name of the route :func:`spmm_auto` serves ``a`` with at width
    ``n``."""
    from tpuspmm.engine.registry import gather_fits
    from tpuspmm.ops import exact

    # extreme-|value| matrices: a single f32 product's rounding can breach
    # the abs-1e-3 gate, so every plain-f32 route is operand luck there —
    # serve the deterministic compensated accumulation, when its
    # (m, W)-padded pass is affordable
    if exact.needs_compensated(a) and exact.exact_admissible(a):
        return "exact"
    if blocksparse_pays(a, n, config):
        return "blocksparse"
    th = thresholds()
    m, k = a.shape
    if (m * k * 4 <= th["densify_max_bytes"]
            and a.sparsity >= th["densify_min_density"]):
        return "densify"
    if a.sparsity < th["gather_max_density"] and gather_fits(a, n):
        return "xla"
    return "vendor"


def spmm_auto(a, b, config=None):
    """Best-route SpMM by :func:`choose_route`."""
    from tpuspmm.config import default_config
    from tpuspmm.kernels import blocksparse_gpu
    from tpuspmm.ops import exact, vendor, xla

    config = config or default_config()
    b = jnp.asarray(b)
    route = choose_route(a, int(b.shape[1]), config)
    if route == "exact":
        return exact.spmm_exact(a, b)
    if route == "densify":
        return xla.spmm_densify_cached(a, b)
    if route == "blocksparse":
        return blocksparse_gpu.spmm_blocksparse(a, b,
                                                interpret=config.interpret)
    if route == "vendor":
        return vendor.spmm_vendor(a, b)
    return spmm_xla_any(a, b)
