"""tpuspmm — sparse linear-algebra framework in JAX for NVIDIA GPUs.

A from-scratch JAX/Pallas re-imagining of the capability surface of the CUDA
reference `mli43/Cuda-Optimization-for-SpMM` (see SURVEY.md): CSR/COO/BSR/ELL
sparse storage, SpMM/SpMV against dense right-hand sides, per-format optimized
kernels, a vendor baseline (jax.experimental.sparse, standing in for cuSPARSE),
an engine that runs/validates/times every kernel variant, and — beyond the
single-GPU reference — multi-chip execution over a `jax.sharding.Mesh`.

Quick start::

    import tpuspmm
    A = tpuspmm.CSR.from_file("data/small_32x32/Hamrle1.csr")
    import numpy as np
    B = np.random.randn(A.shape[1], 128).astype(np.float32)
    C = tpuspmm.spmm(A, B)            # best kernel for this format/platform
"""

from tpuspmm.config import Config, default_config
from tpuspmm.formats import CSR, COO, BSR, ELL, DenseMatrix
from tpuspmm.ops.api import (spmm, spmv, spmm_batched, spmm_transpose,
                             spmm_fn)
from tpuspmm.engine.registry import get_engine, FORMATS

__version__ = "0.1.0"

__all__ = [
    "Config",
    "default_config",
    "CSR",
    "COO",
    "BSR",
    "ELL",
    "DenseMatrix",
    "spmm",
    "spmv",
    "spmm_batched",
    "spmm_transpose",
    "spmm_fn",
    "get_engine",
    "FORMATS",
]
