"""Compressed-sparse-column container.

The reference ships ``.csc`` files alongside ``.csr`` in its data dirs
(e.g. reference/data/small_10x10/sparse.csc; writer commented out at
reference/utils/python_utils/convert_mtx.py:117,151-153) but its binary
never consumes them — included here so every on-disk artifact of the
reference corpus is loadable.  Layout mirrors ``.csr``: header
"rows cols nnz", colptr line, row-index line, values line.

Compute lowers through the shared triplet machinery (CSC is the transpose
view of CSR; there is no column-major kernel advantage — XLA owns
layout).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from tpuspmm.formats.base import MatrixBase, register_format
from tpuspmm.formats import io as fio


@dataclasses.dataclass(frozen=True)
class CSC(MatrixBase):
    indptr: np.ndarray   # (num_cols + 1,) int32
    indices: np.ndarray  # (nnz,) int32 — row ids
    values: np.ndarray   # (nnz,) float32
    shape: Tuple[int, int] = (0, 0)

    format_name = "csc"

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    # --- constructors ---------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "CSC":
        with open(path) as f:
            rows, cols, nnz = (int(t) for t in f.readline().split()[:3])
        body = fio._numeric_body(path, 1)
        indptr = body[: cols + 1].astype(np.int32)
        indices = body[cols + 1 : cols + 1 + nnz].astype(np.int32)
        values = body[cols + 1 + nnz : cols + 1 + 2 * nnz].astype(np.float32)
        return cls(indptr=indptr, indices=indices, values=values, shape=(rows, cols))

    @classmethod
    def from_scipy(cls, m) -> "CSC":
        m = m.tocsc()
        return cls(indptr=m.indptr.astype(np.int32),
                   indices=m.indices.astype(np.int32),
                   values=m.data.astype(np.float32),
                   shape=tuple(m.shape))

    @classmethod
    def from_dense(cls, dense: np.ndarray) -> "CSC":
        import scipy.sparse

        return cls.from_scipy(scipy.sparse.csc_matrix(np.asarray(dense)))

    # --- conversions ----------------------------------------------------
    def to_scipy(self):
        import scipy.sparse

        return scipy.sparse.csc_matrix(
            (np.asarray(self.values), np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        )

    def to_csr(self):
        from tpuspmm.formats.csr import CSR

        return CSR.from_scipy(self.to_scipy())

    def to_coo(self):
        from tpuspmm.formats.coo import COO

        return COO.from_scipy(self.to_scipy())

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray().astype(np.float32)

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(f"{self.shape[0]} {self.shape[1]} {self.nnz}\n")
            f.write(" ".join(map(str, np.asarray(self.indptr).tolist())) + "\n")
            f.write(" ".join(map(str, np.asarray(self.indices).tolist())) + "\n")
            np.savetxt(f, np.asarray(self.values)[None, :], fmt="%.9g")


register_format(CSC, ["indptr", "indices", "values"], ["shape"])
