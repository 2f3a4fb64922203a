"""Column-major ELLPACK container.

Counterpart of `SparseMatrixELL`
(reference/include/formats/sparse_ell.hpp:11-37,
reference/src/formats/sparse_ell.cu).  The reference's ELL is *column-major*:
for each column j of A it stores up to `maxColNnz` (row-index, value) slots,
padded with row index -1 / value 0 (loader sparse_ell.cu:12-55; writer
convert_mtx.py:242-286).  Semantics: C[rowind[j,k], :] += values[j,k] * B[j, :]
for every valid slot — the scatter the reference implements with atomicAdd
(reference/src/spmm/ell/spmm_ell_k1.cu:11-35).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from tpuspmm.formats.base import MatrixBase, register_format
from tpuspmm.formats import io as fio


@dataclasses.dataclass(frozen=True)
class ELL(MatrixBase):
    rowind: np.ndarray  # (num_cols, max_col_nnz) int32, -1 padded
    values: np.ndarray  # (num_cols, max_col_nnz) float32, 0 padded
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0
    max_col_nnz: int = 0

    format_name = "ell"

    # --- constructors ---------------------------------------------------
    @classmethod
    def from_file(cls, rowind_path: str, values_path: str) -> "ELL":
        """Load the reference ELL pair: `*_rowind.ell` + `*_values_colmajor.ell`
        (reference/src/main.cu:210, sparse_ell.cu:12-55)."""
        shape, nnz, mcn, rowind, values = fio.read_ell_text(rowind_path, values_path)
        return cls(rowind=rowind, values=values, shape=shape, nnz=nnz, max_col_nnz=mcn)

    @classmethod
    def from_scipy(cls, m) -> "ELL":
        csc = m.tocsc()
        rows, cols = csc.shape
        col_nnz = np.diff(csc.indptr)
        mcn = int(col_nnz.max()) if cols else 0
        rowind = np.full((cols, mcn), -1, dtype=np.int32)
        values = np.zeros((cols, mcn), dtype=np.float32)
        for j in range(cols):
            s, e = csc.indptr[j], csc.indptr[j + 1]
            rowind[j, : e - s] = csc.indices[s:e]
            values[j, : e - s] = csc.data[s:e]
        return cls(rowind=rowind, values=values, shape=(rows, cols), nnz=int(csc.nnz), max_col_nnz=mcn)

    @classmethod
    def from_dense(cls, dense: np.ndarray) -> "ELL":
        import scipy.sparse

        return cls.from_scipy(scipy.sparse.csc_matrix(np.asarray(dense)))

    # --- conversions ----------------------------------------------------
    def to_dense(self) -> np.ndarray:
        """Equivalent of SparseMatrixELL::toDense
        (reference/src/formats/sparse_ell.cu:161-178)."""
        out = np.zeros(self.shape, dtype=np.float64)
        cols = np.repeat(np.arange(self.shape[1], dtype=np.int64), self.rowind.shape[1] if self.rowind.size else 0)
        rows = np.asarray(self.rowind).ravel()
        vals = np.asarray(self.values).ravel()
        mask = rows >= 0
        np.add.at(out, (rows[mask], cols[mask]), vals[mask])
        return out.astype(np.float32)

    def to_scipy(self):
        return self.to_coo().to_scipy()

    def to_coo(self):
        from tpuspmm.formats.coo import COO

        cols = np.repeat(np.arange(self.shape[1], dtype=np.int32), self.rowind.shape[1] if self.rowind.size else 0)
        rows = np.asarray(self.rowind).ravel()
        vals = np.asarray(self.values).ravel()
        mask = rows >= 0
        return COO(rows=rows[mask].astype(np.int32), cols=cols[mask], values=vals[mask].astype(np.float32), shape=self.shape)

    def save(self, rowind_path: str, values_path: str):
        fio.write_ell_text(
            rowind_path, values_path, self.shape, self.nnz, self.max_col_nnz,
            np.asarray(self.rowind), np.asarray(self.values),
        )


register_format(ELL, ["rowind", "values"], ["shape", "nnz", "max_col_nnz"])
