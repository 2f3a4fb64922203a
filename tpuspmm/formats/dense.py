"""Dense matrix helpers.

Counterpart of `DenseMatrix`
(reference/include/formats/dense.hpp:18-52, reference/src/formats/dense.cu).
A dense operand is just an array; XLA owns physical layout, so the
reference's explicit host-side ordering transpose (`toOrdering`,
dense.cu:140-191) has no device-facing role.  A thin wrapper keeps the
reference's row/col-major notion for file round-trips and report records
("denseOrdering" field, reference/include/utils.hpp:41).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from tpuspmm.formats.base import MatrixBase, register_format
from tpuspmm.formats import io as fio

ROW_MAJOR = "row_major"
COL_MAJOR = "col_major"


@dataclasses.dataclass(frozen=True)
class DenseMatrix(MatrixBase):
    data: np.ndarray  # (rows, cols) float32, logical row-major
    shape: Tuple[int, int] = (0, 0)
    ordering: str = ROW_MAJOR

    format_name = "dense"

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(np.asarray(self.data)))

    @classmethod
    def from_file(cls, path: str) -> "DenseMatrix":
        """Load `dense.in` (reference/src/formats/dense.cu:9-36)."""
        arr = fio.read_dense_text(path)
        return cls(data=arr, shape=tuple(arr.shape))

    @classmethod
    def from_array(cls, arr) -> "DenseMatrix":
        arr = np.asarray(arr, dtype=np.float32)
        return cls(data=arr, shape=tuple(arr.shape))

    def to_ordering(self, ordering: str) -> "DenseMatrix":
        """Logical no-op on values; records the requested physical ordering
        (reference DenseMatrix::toOrdering, dense.cu:140-191, physically
        transposes the buffer — XLA manages layout)."""
        if ordering == self.ordering:
            return self
        return dataclasses.replace(self, ordering=ordering)

    def save(self, path: str):
        """Equivalent of DenseMatrix::save2File
        (reference/src/formats/dense.cu:193-232)."""
        fio.write_dense_text(path, np.asarray(self.data))


def load_dense_text(path: str) -> np.ndarray:
    return fio.read_dense_text(path)


def save_dense_text(path: str, arr) -> None:
    fio.write_dense_text(path, np.asarray(arr))


register_format(DenseMatrix, ["data"], ["shape", "ordering"])
