"""Coordinate-format container.

Counterpart of `SparseMatrixCOO`
(reference/include/formats/sparse_coo.hpp:11-39,
reference/src/formats/sparse_coo.cu).  COO semantics follow the reference's
atomicAdd scatter kernel (reference/src/spmm/coo/spmm_coo_k1.cu:24): duplicate
coordinates accumulate.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from tpuspmm.formats.base import MatrixBase, register_format
from tpuspmm.formats import io as fio


@dataclasses.dataclass(frozen=True)
class COO(MatrixBase):
    rows: np.ndarray  # (nnz,) int32
    cols: np.ndarray  # (nnz,) int32
    values: np.ndarray  # (nnz,) float32
    shape: Tuple[int, int] = (0, 0)
    row_sorted: bool = False

    format_name = "coo"

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    # --- constructors ---------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "COO":
        """Load the reference `.coo` text format
        (reference/src/formats/sparse_coo.cu:12-38); the converter writes
        triplets lexsorted row-major (reference convert_matrix.py:97-116)."""
        shape, r, c, v = fio.read_coo_text(path)
        sorted_flag = bool(np.all(np.diff(r) >= 0))
        return cls(rows=r, cols=c, values=v, shape=shape, row_sorted=sorted_flag)

    @classmethod
    def from_scipy(cls, m) -> "COO":
        m = m.tocoo()
        return cls(
            rows=m.row.astype(np.int32),
            cols=m.col.astype(np.int32),
            values=m.data.astype(np.float32),
            shape=tuple(m.shape),
            row_sorted=bool(np.all(np.diff(m.row) >= 0)),
        )

    @classmethod
    def from_dense(cls, dense: np.ndarray) -> "COO":
        import scipy.sparse

        return cls.from_scipy(scipy.sparse.coo_matrix(np.asarray(dense)))

    @classmethod
    def random(cls, rows: int, cols: int, density: float, seed: int = 0) -> "COO":
        from tpuspmm.formats.csr import CSR

        return CSR.random(rows, cols, density, seed).to_coo()

    # --- conversions ----------------------------------------------------
    def sort_by_row(self) -> "COO":
        if self.row_sorted:
            return self
        order = np.lexsort((np.asarray(self.cols), np.asarray(self.rows)))
        return dataclasses.replace(
            self,
            rows=np.asarray(self.rows)[order],
            cols=np.asarray(self.cols)[order],
            values=np.asarray(self.values)[order],
            row_sorted=True,
        )

    def to_dense(self) -> np.ndarray:
        """Equivalent of SparseMatrixCOO::toDense
        (reference/src/formats/sparse_coo.cu:153-168); duplicates accumulate."""
        out = np.zeros(self.shape, dtype=np.float64)
        np.add.at(out, (np.asarray(self.rows), np.asarray(self.cols)), np.asarray(self.values))
        return out.astype(np.float32)

    def to_scipy(self):
        import scipy.sparse

        return scipy.sparse.coo_matrix(
            (np.asarray(self.values), (np.asarray(self.rows), np.asarray(self.cols))),
            shape=self.shape,
        )

    def to_csr(self):
        from tpuspmm.formats.csr import CSR

        return CSR.from_scipy(self.to_scipy())

    def save(self, path: str):
        fio.write_coo_text(path, self.shape, np.asarray(self.rows), np.asarray(self.cols), np.asarray(self.values))


register_format(COO, ["rows", "cols", "values"], ["shape", "row_sorted"])
