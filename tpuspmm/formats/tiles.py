"""Tile-plan preprocessing: unstructured sparsity → fixed-size tile chunks.

`build_tile_plan` groups the nonzeros of any format (via row/col/val
triplets) by (row-tile, k-tile), orders groups row-tile-major, and splits
each group into fixed-size chunks of E nonzeros (padded with sentinel
row=-1) — nnz-balanced static-shape work, the merge-path idea of the
reference's K2 warp rotation (spmm_csr_k2.cu:10-58).  The sharded xla
local (tpuspmm/parallel/spmm.py) reads the plan as its triplet layout:
every shard's plan has the same static shape, so the stacked plans shard
over a mesh axis.

Every row tile gets at least one (possibly all-sentinel) chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Static-shape chunked tiling of a sparse matrix (host-built)."""

    # per-chunk scalars
    rt: np.ndarray  # (C,) int32 — row-tile id, non-decreasing
    kt: np.ndarray  # (C,) int32 — k-tile id
    first: np.ndarray  # (C,) int32 — 1 iff first chunk of its row tile
    # per-chunk nnz payload
    rows: np.ndarray  # (C, E) int32 — row offset within tile, -1 = padding
    cols: np.ndarray  # (C, E) int32 — col offset within tile
    vals: np.ndarray  # (C, E) float32

    shape: Tuple[int, int]
    tile_m: int
    tile_k: int
    chunk: int

    @property
    def num_chunks(self) -> int:
        return int(self.rt.shape[0])

    @property
    def num_row_tiles(self) -> int:
        return _cdiv(self.shape[0], self.tile_m)

    @property
    def num_k_tiles(self) -> int:
        return _cdiv(self.shape[1], self.tile_k)


# past this many nonzeros the C++ builder (single stable sort + linear
# walk) beats numpy's argsort+fancy-gather pipeline; below it the ctypes
# round trip isn't worth it
NATIVE_MIN_NNZ = 200_000


def build_tile_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    tile_m: int = 128,
    tile_k: int = 128,
    chunk: int = 128,
) -> TilePlan:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)

    if len(rows) >= NATIVE_MIN_NNZ:
        from tpuspmm.native import tileplan as native_tp

        if native_tp.available():
            rt, kt, first, prows, pcols, pvals = native_tp.build_tile_plan_arrays(
                rows, cols, vals, shape, tile_m, tile_k, chunk)
            return TilePlan(rt=rt, kt=kt, first=first,
                            rows=prows, cols=pcols, vals=pvals,
                            shape=tuple(shape), tile_m=tile_m,
                            tile_k=tile_k, chunk=chunk)
    nrt = _cdiv(shape[0], tile_m)
    nkt = _cdiv(shape[1], tile_k)

    tile_r = rows // tile_m
    tile_k_ids = cols // tile_k
    # stable sort on the combined (tile_r, tile_k) key — within-group order
    # is irrelevant to correctness (duplicates accumulate in the sum)
    order = np.argsort(tile_r * _cdiv(shape[1], tile_k) + tile_k_ids, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    tile_r, tile_k_ids = tile_r[order], tile_k_ids[order]

    group_key = tile_r * nkt + tile_k_ids
    # group boundaries
    if len(group_key):
        gb = np.flatnonzero(np.diff(group_key)) + 1
        starts = np.concatenate([[0], gb]).astype(np.int64)
        ends = np.concatenate([gb, [len(group_key)]]).astype(np.int64)
    else:
        starts = np.zeros(0, dtype=np.int64)
        ends = np.zeros(0, dtype=np.int64)

    # split each (row-tile, k-tile) group into fixed-size chunks — fully
    # vectorised (a Python loop here dominates prolog time at millions of nnz)
    g_sizes = ends - starts
    g_nchunks = -(-g_sizes // chunk) if len(g_sizes) else g_sizes
    n_data_chunks = int(g_nchunks.sum())
    chunk_group = np.repeat(np.arange(len(starts), dtype=np.int64), g_nchunks)
    within = (np.arange(n_data_chunks, dtype=np.int64)
              - np.repeat(np.cumsum(g_nchunks) - g_nchunks, g_nchunks))
    c_start = starts[chunk_group] + within * chunk
    c_end = np.minimum(c_start + chunk, ends[chunk_group])
    c_rt = tile_r[starts[chunk_group]] if n_data_chunks else np.zeros(0, np.int64)
    c_kt = tile_k_ids[starts[chunk_group]] if n_data_chunks else np.zeros(0, np.int64)

    # ensure every row tile has at least one chunk (zero-fill semantics)
    present = np.zeros(nrt, dtype=bool)
    present[c_rt] = True
    missing = np.flatnonzero(~present).astype(np.int64)
    if len(missing):
        c_rt = np.concatenate([c_rt, missing])
        c_kt = np.concatenate([c_kt, np.zeros(len(missing), np.int64)])
        c_start = np.concatenate([c_start, np.zeros(len(missing), np.int64)])
        c_end = np.concatenate([c_end, np.zeros(len(missing), np.int64)])

    # order chunks by row tile (stable: keeps k-tile grouping within)
    corder = np.argsort(c_rt, kind="stable")
    c_rt, c_kt = c_rt[corder], c_kt[corder]
    c_start, c_end = c_start[corder], c_end[corder]
    C = len(c_rt)
    E = chunk
    # pad the chunk count to a multiple of 8 (the native builder's
    # contract); padding chunks are all-sentinel and attach to the last
    # row tile
    C_pad = _cdiv(max(C, 1), 8) * 8

    out_rt = np.zeros(C_pad, dtype=np.int32)
    out_kt = np.zeros(C_pad, dtype=np.int32)
    out_first = np.zeros(C_pad, dtype=np.int32)
    out_rows = np.full((C_pad, E), -1, dtype=np.int32)
    out_cols = np.zeros((C_pad, E), dtype=np.int32)
    out_vals = np.zeros((C_pad, E), dtype=np.float32)

    out_rt[:C] = c_rt
    out_kt[:C] = c_kt
    if C:
        out_first[0] = 1
        out_first[1:C] = (c_rt[1:] != c_rt[:-1]).astype(np.int32)
    # scatter the payload: chunk ci takes triplets [c_start[ci], c_end[ci])
    lengths = c_end - c_start
    total = int(lengths.sum())
    if total:
        cum = np.cumsum(lengths)
        in_chunk = np.arange(total, dtype=np.int64) - np.repeat(cum - lengths, lengths)
        src = np.repeat(c_start, lengths) + in_chunk
        dst = np.repeat(np.arange(C_pad, dtype=np.int64)[: len(lengths)] * E,
                        lengths) + in_chunk
        rt_rep = np.repeat(c_rt, lengths)
        kt_rep = np.repeat(c_kt, lengths)
        out_rows.ravel()[dst] = (rows[src] - rt_rep * tile_m).astype(np.int32)
        out_cols.ravel()[dst] = (cols[src] - kt_rep * tile_k).astype(np.int32)
        out_vals.ravel()[dst] = vals[src]

    # padding chunks (C..C_pad) attach to the last visited row tile so the
    # grid order stays row-tile-monotonic; all-sentinel rows contribute 0
    if C_pad > C:
        last_rt = out_rt[C - 1] if C else 0
        out_rt[C:] = last_rt
        # first=0: never re-zero the tile; kt=0 is safe (B tile 0 unused)

    return TilePlan(
        rt=out_rt, kt=out_kt, first=out_first,
        rows=out_rows, cols=out_cols, vals=out_vals,
        shape=tuple(shape), tile_m=tile_m, tile_k=tile_k, chunk=chunk,
    )
