"""Per-format kernel registries.

Counterpart of the reference engine hierarchy
(reference/include/engine/engine_base.hpp:5-10 and the per-format engines,
engine_csr.hpp:27-91 etc.).  Kernel numbering follows the reference
convention (reference/src/engine/engine.cpp:16-61):

- ``-1`` — vendor baseline (cuSPARSE, through jax.experimental.sparse)
- ``0``  — sequential oracle (numpy float64)
- ``1..numKernels`` — optimized variants

Every format has four: its XLA gather route, the cached densify
(cuBLAS), the block-sparse Triton kernel and the compensated-f32 route.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class KernelVariant:
    number: int
    name: str
    fn: Callable  # (a, b, config) -> array
    description: str = ""
    # admission predicate; mirrors K4's bail-out heuristic
    # (reference/src/spmm/csr/spmm_csr_k4.cu:91-101)
    admissible: Optional[Callable] = None
    # a Pallas GPU kernel: admissible only on a GPU, or interpreted when
    # the config asks for it (never interpreted silently)
    requires_gpu: bool = False

    def inadmissible_reason(self, a, b, config) -> str:
        """Why this variant cannot serve (a, b), or "" when it can."""
        if self.requires_gpu:
            from tpuspmm.kernels.blocksparse_gpu import runnable

            if not runnable(config.interpret):
                return ("Pallas Triton kernel needs a GPU (interpret mode "
                        "not requested)")
        if self.admissible is not None and not self.admissible(a, b, config):
            return "admission predicate refused this operand"
        return ""


@dataclasses.dataclass
class Engine:
    fmt: str
    variants: List[KernelVariant]
    supports_vendor: bool = True

    @property
    def num_kernels(self) -> int:
        return len(self.variants)

    def variant(self, number: int) -> KernelVariant:
        for v in self.variants:
            if v.number == number:
                return v
        raise KeyError(number)

    def run_kernel(self, number: int, a, b, config=None):
        """Reference EngineBase::runKernel equivalent
        (engine_base.hpp:5-10): -1 vendor, 0 oracle, 1..N variants."""
        from tpuspmm.ops import oracle, vendor
        from tpuspmm.config import default_config

        config = config or default_config()
        if number == -1:
            return vendor.spmm_vendor(a, b)
        if number == 0:
            return oracle.spmm_oracle(a, np.asarray(b))
        return self.variant(number).fn(a, b, config)


# --------------------------------------------------------------------------
# variant implementations (thin adapters over ops/ and kernels/)
# --------------------------------------------------------------------------

def _csr_xla(a, b, config):
    from tpuspmm.ops import xla

    return xla.spmm_csr_xla(a, b)


GATHER_MAX_BYTES = 2 << 30  # 2 GiB intermediate cap for materializing paths


def gather_fits(a, n: int) -> bool:
    """Does the gather route's (count, n) intermediate fit GATHER_MAX_BYTES?"""
    from tpuspmm.kernels.common import round_up

    # ELL flattens ALL padded slots (incl. -1 sentinels) into triplets —
    # the intermediate scales with rowind.size, not nnz, and a
    # column-skewed matrix pads every column to the max count
    count = (int(np.asarray(a.rowind).size)
             if getattr(a, "rowind", None) is not None else a.nnz)
    return count * round_up(n, 128) * 4 <= GATHER_MAX_BYTES


def _gather_ok(a, b, config):
    """Admission for the XLA gather+segment-sum family: the lowering
    MATERIALIZES the (nnz, n) gathered-B intermediate (ops/xla.py
    spmm_triplets), which at reference widths can dwarf device memory —
    e.g. large_20000's on-disk dense operand is 20000 wide, so the
    intermediate is 137736 x 20000 x 4 B = 11 GB.
    The reference's CUDA kernels read B in place per element
    (spmm_csr_k1.cu:28-31) and never hit this; skipping with an
    'inadmissible' record is the honest equivalent of K4's shared-memory bail
    (spmm_csr_k4.cu:92-101)."""
    return gather_fits(a, int(np.shape(b)[1]))


def _bsr_gather_ok(a, b, config):
    """BSR einsum admission: the gathered B panels are
    (nblocks, block_w, n) — same materialization hazard as _gather_ok."""
    from tpuspmm.kernels.common import round_up

    n_pad = round_up(int(np.shape(b)[1]), 128)
    nblocks = int(a.blocks.shape[0]) if getattr(a, "blocks", None) is not None else 0
    bw = int(a.blocks.shape[2]) if nblocks else 1
    return nblocks * bw * n_pad * 4 <= GATHER_MAX_BYTES


def _densify_matmul(a, b, config):
    from tpuspmm.ops import xla

    return xla.spmm_densify_cached(a, b)


def _densify_ok(a, b, config):
    # The cached densify pays a one-time host scatter + full-dense H2D
    # transfer and pins the dense operand in device memory for the
    # container's lifetime, so admission keeps hyper-sparse LARGE
    # matrices from paying ~1 GiB of transfer for a variant that cannot
    # win.  Dense operands up to the device's densify cap are always
    # worth measuring; between that and the 1 GiB hard cap only matrices
    # at or above the density floor qualify.
    from tpuspmm.kernels.dispatch import thresholds

    th = thresholds()
    dense_bytes = a.shape[0] * a.shape[1] * 4
    if dense_bytes <= th["densify_max_bytes"]:
        return True
    return (dense_bytes <= (1 << 30)
            and a.sparsity >= th["densify_min_density"])


def blocksparse_fits(a) -> bool:
    """Does the block-sparse kernel's plan fit GATHER_MAX_BYTES?  Counted
    from the triplets, without building a tile: a scattered matrix's plan
    stores a whole tile per nonzero."""
    from tpuspmm.kernels.blocksparse_gpu import plan_stats

    return plan_stats(a).plan_bytes <= GATHER_MAX_BYTES


def _blocksparse_ok(a, b, config):
    return blocksparse_fits(a)


def _blocksparse(a, b, config):
    from tpuspmm.kernels import blocksparse_gpu

    return blocksparse_gpu.spmm_blocksparse(a, b, interpret=config.interpret)


def _compensated(a, b, config):
    from tpuspmm.ops import exact

    return exact.spmm_exact(a, b)


def _compensated_ok(a, b, config):
    # skip (don't crash) matrices whose (m, W) slot padding makes the
    # compensated pass unaffordable — e.g. one heavy row in a huge matrix
    from tpuspmm.ops import exact

    return exact.exact_admissible(a)


def _coo_xla(a, b, config):
    from tpuspmm.ops import xla

    return xla.spmm_coo_xla(a, b)


def _bsr_xla(a, b, config):
    from tpuspmm.ops import xla

    return xla.spmm_bsr_xla(a, b)


def _ell_xla(a, b, config):
    from tpuspmm.ops import xla

    return xla.spmm_ell_xla(a, b)


def build_engines() -> Dict[str, Engine]:
    def blocksparse(number):
        return KernelVariant(
            number, "triton_blocksparse", _blocksparse,
            "plan-time (64×64) tile densification, Pallas/Triton kernel: "
            "each program walks its row block's tiles, B tile in shared "
            "memory, partial sums in registers",
            admissible=_blocksparse_ok, requires_gpu=True)

    def compensated(number):
        return KernelVariant(
            number, "xla_compensated", _compensated,
            "Dekker/TwoSum compensated f32 accumulation — deterministic "
            "gate pass for extreme-|value| matrices (≙ the f64 "
            "accumulator guarantee, main.cu:185)",
            admissible=_compensated_ok)

    def densify(number):
        return KernelVariant(
            number, "xla_densify_matmul", _densify_matmul,
            "cached densify + one dense cuBLAS matmul (wins the "
            "high-density sweep)",
            admissible=_densify_ok)

    return {
        "csr": Engine(fmt="csr", variants=[
            KernelVariant(1, "xla_segment_sum", _csr_xla,
                          "gather + row segment-sum (≙ K1/K3 row-parallel, "
                          "spmm_csr_k1.cu:12-34)",
                          admissible=_gather_ok),
            densify(2), blocksparse(3), compensated(4)]),
        "coo": Engine(fmt="coo", variants=[
            KernelVariant(1, "xla_segment_sum", _coo_xla,
                          "atomic-free scatter via segment-sum (≙ K5 "
                          "atomicAdd, spmm_coo_k1.cu:8-27)",
                          admissible=_gather_ok),
            blocksparse(2), compensated(3), densify(4)]),
        "bsr": Engine(fmt="bsr", variants=[
            KernelVariant(1, "xla_block_einsum", _bsr_xla,
                          "gathered-panel batched matmul + block-row "
                          "segment-sum (≙ K6, spmm_bsr_k1.cu:8-41)",
                          admissible=_bsr_gather_ok),
            blocksparse(2), compensated(3), densify(4)]),
        "ell": Engine(fmt="ell", variants=[
            KernelVariant(1, "xla_segment_sum", _ell_xla,
                          "column-slot scatter via segment-sum (≙ K7/K8 "
                          "atomicAdd scatter, spmm_ell_k1.cu:11-35)",
                          admissible=_gather_ok),
            blocksparse(2), compensated(3), densify(4)]),
    }


_ENGINES: Optional[Dict[str, Engine]] = None
FORMATS = ("csr", "coo", "bsr", "ell")


def get_engine(fmt: str) -> Engine:
    global _ENGINES
    if _ENGINES is None:
        _ENGINES = build_engines()
    return _ENGINES[fmt.lower()]
