"""Block Sparse Row container.

Counterpart of `SparseMatrixBSR`
(reference/include/formats/sparse_bsr.hpp:12-57,
reference/src/formats/sparse_bsr.cu): the format of block-pruned weights,
whose stored blocks the block-sparse kernel (tpuspmm/kernels/
blocksparse_gpu.py) re-tiles into its dense tiles.
Unlike the reference — whose shipped data degenerates to 1×1 blocks
(reference/utils/python_utils/convert_mtx.py:22) and whose `fromDense`
throws Not-Implemented (reference/src/formats/sparse_bsr.cu:254-295) —
real block sizes and dense round-tripping are fully supported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from tpuspmm.formats.base import MatrixBase, register_format
from tpuspmm.formats import io as fio


@dataclasses.dataclass(frozen=True)
class BSR(MatrixBase):
    indptr: np.ndarray  # (num_block_rows+1,) int32
    indices: np.ndarray  # (nblocks,) int32 — block-column index per block
    blocks: np.ndarray  # (nblocks, brows, bcols) float32
    shape: Tuple[int, int] = (0, 0)
    block_size: Tuple[int, int] = (1, 1)
    nnz: int = 0  # scalar nnz of the underlying matrix (header field)

    format_name = "bsr"

    @property
    def num_block_rows(self) -> int:
        return self.shape[0] // self.block_size[0]

    @property
    def num_block_cols(self) -> int:
        return self.shape[1] // self.block_size[1]

    @property
    def nblocks(self) -> int:
        return int(self.blocks.shape[0])

    # --- constructors ---------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "BSR":
        """Load the reference `.bsr` text format
        (reference/src/formats/sparse_bsr.cu:17-61; header
        "rows cols nnz brows bcols nblocks")."""
        shape, nnz, bs, indptr, indices, blocks = fio.read_bsr_text(path)
        return cls(indptr=indptr, indices=indices, blocks=blocks, shape=shape, block_size=bs, nnz=nnz)

    @classmethod
    def from_scipy(cls, m, block_size: Tuple[int, int] = (4, 4)) -> "BSR":
        # shrink the block until it divides the shape — the reference
        # converter's fallback loop (convert_matrix.py:19-27 halves `size`
        # down to 1×1)
        bh, bw = block_size
        rows, cols = m.shape
        while bh > 1 and rows % bh != 0:
            bh //= 2
        while bw > 1 and cols % bw != 0:
            bw //= 2
        m = m.tobsr(blocksize=(bh, bw))
        return cls(
            indptr=m.indptr.astype(np.int32),
            indices=m.indices.astype(np.int32),
            blocks=m.data.astype(np.float32),
            shape=tuple(m.shape),
            block_size=tuple(m.blocksize),
            nnz=int(m.nnz),
        )

    @classmethod
    def from_dense(cls, dense: np.ndarray, block_size: Tuple[int, int] = (4, 4)) -> "BSR":
        import scipy.sparse

        return cls.from_scipy(scipy.sparse.csr_matrix(np.asarray(dense)), block_size)

    @classmethod
    def random_blocks(
        cls,
        rows: int,
        cols: int,
        block_size: Tuple[int, int],
        block_density: float,
        seed: int = 0,
    ) -> "BSR":
        """Random block-sparse matrix (pruned-LLM style: dense blocks at a
        given block-level density — BASELINE.json config 4)."""
        rng = np.random.default_rng(seed)
        bh, bw = block_size
        assert rows % bh == 0 and cols % bw == 0
        nbr, nbc = rows // bh, cols // bw
        mask = rng.random((nbr, nbc)) < block_density
        indptr = np.zeros(nbr + 1, dtype=np.int32)
        indptr[1:] = np.cumsum(mask.sum(axis=1)).astype(np.int32)
        indices = np.concatenate([np.nonzero(mask[i])[0] for i in range(nbr)] or [np.zeros(0)]).astype(np.int32)
        nblocks = int(indptr[-1])
        blocks = rng.standard_normal((nblocks, bh, bw)).astype(np.float32)
        return cls(indptr=indptr, indices=indices, blocks=blocks, shape=(rows, cols), block_size=(bh, bw), nnz=nblocks * bh * bw)

    # --- conversions ----------------------------------------------------
    def to_scipy(self):
        import scipy.sparse

        return scipy.sparse.bsr_matrix(
            (np.asarray(self.blocks), np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        )

    def to_dense(self) -> np.ndarray:
        """Equivalent of SparseMatrixBSR::toDense
        (reference/src/formats/sparse_bsr.cu:297-326)."""
        return self.to_scipy().toarray().astype(np.float32)

    def to_csr(self):
        from tpuspmm.formats.csr import CSR

        return CSR.from_scipy(self.to_scipy().tocsr())

    def save(self, path: str):
        fio.write_bsr_text(
            path, self.shape, self.nnz, self.block_size,
            np.asarray(self.indptr), np.asarray(self.indices), np.asarray(self.blocks),
        )


register_format(BSR, ["indptr", "indices", "blocks"], ["shape", "block_size", "nnz"])
