"""Compressed Sparse Row container.

Counterpart of `SparseMatrixCSR`
(reference/include/formats/sparse_csr.hpp:11-39,
reference/src/formats/sparse_csr.cu).  Arrays may be numpy or jax; the class
is a registered pytree so it can cross `jit` boundaries directly instead of
via the reference's manual `copy2Device` (sparse_csr.cu:110-128).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from tpuspmm.formats.base import MatrixBase, register_format
from tpuspmm.formats import io as fio


@dataclasses.dataclass(frozen=True)
class CSR(MatrixBase):
    indptr: np.ndarray  # (rows+1,) int32
    indices: np.ndarray  # (nnz,)   int32
    values: np.ndarray  # (nnz,)   float32
    shape: Tuple[int, int] = (0, 0)

    format_name = "csr"

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    # --- constructors ---------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "CSR":
        """Load the reference `.csr` text format
        (reference/src/formats/sparse_csr.cu:12-51)."""
        shape, indptr, indices, values = fio.read_csr_text(path)
        return cls(indptr=indptr, indices=indices, values=values, shape=shape)

    @classmethod
    def from_scipy(cls, m) -> "CSR":
        m = m.tocsr()
        return cls(
            indptr=m.indptr.astype(np.int32),
            indices=m.indices.astype(np.int32),
            values=m.data.astype(np.float32),
            shape=tuple(m.shape),
        )

    @classmethod
    def from_dense(cls, dense: np.ndarray) -> "CSR":
        import scipy.sparse

        return cls.from_scipy(scipy.sparse.csr_matrix(np.asarray(dense)))

    @classmethod
    def random(cls, rows: int, cols: int, density: float, seed: int = 0,
               lo: float = -100.0, hi: float = 100.0) -> "CSR":
        """Synthetic matrix; defaults match the reference generator's recipe
        (uniform values in [-100, 100], reference
        utils/python_utils/gen_sparse.py:63-84).  Note: at that value scale
        and high density, f32 kernels cannot meet the abs-1e-3 gate on
        catastrophically-cancelling outputs — pass lo/hi = ±1 when the
        result feeds a verification sweep."""
        import scipy.sparse

        rng = np.random.default_rng(seed)
        m = scipy.sparse.random(
            rows, cols, density=density, format="csr", random_state=rng,
            data_rvs=lambda n: rng.uniform(lo, hi, n),
        )
        return cls.from_scipy(m)

    # --- conversions ----------------------------------------------------
    def to_dense(self) -> np.ndarray:
        """Equivalent of SparseMatrixCSR::toDense
        (reference/src/formats/sparse_csr.cu:163-180)."""
        return self.to_scipy().toarray().astype(np.float32)

    def to_scipy(self):
        import scipy.sparse

        return scipy.sparse.csr_matrix(
            (np.asarray(self.values), np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        )

    def to_coo(self):
        from tpuspmm.formats.coo import COO

        return COO.from_scipy(self.to_scipy().tocoo())

    def save(self, path: str):
        fio.write_csr_text(path, self.shape, np.asarray(self.indptr), np.asarray(self.indices), np.asarray(self.values))

    def row_lengths(self) -> np.ndarray:
        ip = np.asarray(self.indptr)
        return ip[1:] - ip[:-1]


register_format(CSR, ["indptr", "indices", "values"], ["shape"])
