"""Sparse/dense matrix containers (JAX-pytree friendly).

Re-design of the reference's format layer
(`reference/include/formats/matrix.hpp:16-47` class hierarchy and the
per-format loaders in `reference/src/formats/*.cu`).  Unlike the reference's
host/device pointer-juggling classes, these are immutable dataclasses whose
array fields may be numpy (host) or jax.Array (device) — placement is just
`jax.device_put` on the pytree.
"""

from tpuspmm.formats.dense import DenseMatrix, load_dense_text, save_dense_text
from tpuspmm.formats.csr import CSR
from tpuspmm.formats.csc import CSC
from tpuspmm.formats.coo import COO
from tpuspmm.formats.bsr import BSR
from tpuspmm.formats.ell import ELL
from tpuspmm.formats import convert

__all__ = [
    "DenseMatrix",
    "CSR",
    "CSC",
    "COO",
    "BSR",
    "ELL",
    "convert",
    "load_dense_text",
    "save_dense_text",
]
