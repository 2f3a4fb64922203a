"""Host-side partitioning of sparse operands for mesh execution.

Three layouts:

- ``RowShardedPlan`` — the sparse matrix split into R row slabs, each
  lowered to the tile-chunk layout of tpuspmm/formats/tiles.py and padded
  to a uniform chunk count so the stacked arrays shard cleanly over the
  ``"rows"`` mesh axis (leading dim R).  Used when B is replicated or
  column-sharded: purely local compute, no collectives.

- ``KBucketedTriplets`` — each row slab's nonzeros additionally bucketed
  by which K-shard of B they touch, padded to a uniform bucket size with
  row=-1 sentinels (dropped by the segment-sum kernel, matching the ELL
  padding convention, reference/src/formats/sparse_ell.cu:12-55).  Used by
  the ring schedule: at ring step i a device holds B panel ``src`` and
  consumes bucket ``src``.

- ``StackedBlockPlans`` — a block-sparse plan per row shard or per
  (row shard, k bucket), stacked for the ``"blocksparse"`` local.

All pad the row dimension so every shard has identical static shapes —
the shard_map bodies are traced once for all devices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from tpuspmm.formats.tiles import build_tile_plan
from tpuspmm.kernels.common import cdiv, round_up


def _to_coo_arrays(a) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    coo = a if a.format_name == "coo" else (a.to_coo() if hasattr(a, "to_coo") else a.to_csr().to_coo())
    return (
        np.asarray(coo.rows, dtype=np.int64),
        np.asarray(coo.cols, dtype=np.int64),
        np.asarray(coo.values, dtype=np.float32),
        tuple(coo.shape),
    )


@dataclasses.dataclass(frozen=True)
class RowShardedPlan:
    """Stacked per-shard tile plans; leading dim = row-shard index."""

    rt: np.ndarray      # (R, C) int32
    kt: np.ndarray      # (R, C) int32
    first: np.ndarray   # (R, C) int32
    rows: np.ndarray    # (R, C, E) int32
    cols: np.ndarray    # (R, C, E) int32
    vals: np.ndarray    # (R, C, E) float32

    shape: Tuple[int, int]       # global (M, K)
    n_shards: int
    m_local: int                 # padded rows per shard (multiple of tile_m)
    tile_m: int
    tile_k: int
    chunk: int

    @property
    def num_chunks(self) -> int:
        return int(self.rt.shape[1])

    @property
    def num_row_tiles(self) -> int:
        return self.m_local // self.tile_m

    @property
    def num_k_tiles(self) -> int:
        return cdiv(self.shape[1], self.tile_k)


def _stack_plans(plans, shape, n_shards, m_local, tile_m, tile_k, chunk):
    c_max = round_up(max(p.num_chunks for p in plans), 8)
    R, E = n_shards, chunk
    out = {
        "rt": np.zeros((R, c_max), np.int32),
        "kt": np.zeros((R, c_max), np.int32),
        "first": np.zeros((R, c_max), np.int32),
        "rows": np.full((R, c_max, E), -1, np.int32),
        "cols": np.zeros((R, c_max, E), np.int32),
        "vals": np.zeros((R, c_max, E), np.float32),
    }
    for s, p in enumerate(plans):
        c = p.num_chunks
        out["rt"][s, :c] = p.rt
        out["kt"][s, :c] = p.kt
        out["first"][s, :c] = p.first
        out["rows"][s, :c] = p.rows
        out["cols"][s, :c] = p.cols
        out["vals"][s, :c] = p.vals
        if c < c_max:  # padding chunks stay on the last row tile, no re-zero
            out["rt"][s, c:] = p.rt[c - 1] if c else 0
    return RowShardedPlan(shape=shape, n_shards=n_shards, m_local=m_local,
                          tile_m=tile_m, tile_k=tile_k, chunk=chunk, **out)


def shard_rows_tileplan(a, n_shards: int, tile_m: int = 128, tile_k: int = 128,
                        chunk: int = 128) -> RowShardedPlan:
    """Split A into ``n_shards`` row slabs and lower each to a TilePlan,
    padding all plans to the max chunk count."""
    rows, cols, vals, (m, k) = _to_coo_arrays(a)
    m_local = round_up(cdiv(m, n_shards), tile_m)

    plans = []
    for s in range(n_shards):
        lo, hi = s * m_local, min((s + 1) * m_local, m)
        sel = (rows >= lo) & (rows < hi)
        plans.append(
            build_tile_plan(rows[sel] - lo, cols[sel], vals[sel], (m_local, k),
                            tile_m=tile_m, tile_k=tile_k, chunk=chunk)
        )
    return _stack_plans(plans, (m, k), n_shards, m_local, tile_m, tile_k, chunk)


def shard_rows_tileplan_transposed(a, n_shards: int, tile_m: int = 128,
                                   tile_k: int = 128, chunk: int = 128) -> RowShardedPlan:
    """Per-row-slab TilePlans of Aᵀ: shard s's plan computes
    ``A[lo:hi, :]ᵀ @ X`` for an (m_local, n) operand X — the backward of
    the row-sharded forward (dB = Σ_s A_sᵀ @ res_s, psum over shards).
    Plan shape per shard is (K, m_local); ``m_local`` (the contraction
    dim) must be a multiple of ``tile_k``, which `shard_rows_tileplan`'s
    tile_m alignment guarantees when tile_m == tile_k."""
    rows, cols, vals, (m, k) = _to_coo_arrays(a)
    m_local = round_up(cdiv(m, n_shards), max(tile_m, tile_k))

    plans = []
    for s in range(n_shards):
        lo, hi = s * m_local, min((s + 1) * m_local, m)
        sel = (rows >= lo) & (rows < hi)
        plans.append(
            build_tile_plan(cols[sel], rows[sel] - lo, vals[sel], (k, m_local),
                            tile_m=tile_m, tile_k=tile_k, chunk=chunk)
        )
    # m_local of the *transposed* plan = its padded output rows (= K padded),
    # keeping RowShardedPlan.num_row_tiles/num_k_tiles consistent
    return _stack_plans(plans, (k, m_local), n_shards,
                        round_up(k, tile_m), tile_m, tile_k, chunk)


@dataclasses.dataclass(frozen=True)
class KBucketedTriplets:
    """Per (row-shard, k-shard) triplet buckets, sentinel-padded."""

    rows: np.ndarray  # (R, S, E) int32 — local row id, -1 = padding
    cols: np.ndarray  # (R, S, E) int32 — col id local to the k-shard
    vals: np.ndarray  # (R, S, E) float32

    shape: Tuple[int, int]
    n_row_shards: int
    n_k_shards: int
    m_local: int
    k_local: int

    @property
    def bucket_size(self) -> int:
        return int(self.rows.shape[2])


def bucket_triplets(a, n_row_shards: int, n_k_shards: int,
                    m_align: int = 8, k_align: int = 128) -> KBucketedTriplets:
    """Bucket A's nonzeros by (row shard, k shard) with uniform padding."""
    rows, cols, vals, (m, k) = _to_coo_arrays(a)
    m_local = round_up(cdiv(m, n_row_shards), m_align)
    k_local = round_up(cdiv(k, n_k_shards), k_align)

    r_shard = rows // m_local
    k_shard = cols // k_local
    key = r_shard * n_k_shards + k_shard
    counts = np.bincount(key, minlength=n_row_shards * n_k_shards)
    e_max = max(int(counts.max()) if len(counts) else 0, 1)
    e_max = round_up(e_max, 8)

    R, S = n_row_shards, n_k_shards
    out_rows = np.full((R, S, e_max), -1, np.int32)
    out_cols = np.zeros((R, S, e_max), np.int32)
    out_vals = np.zeros((R, S, e_max), np.float32)

    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    boundaries = np.searchsorted(sorted_key, np.arange(R * S + 1))
    for b in range(R * S):
        s0, s1 = boundaries[b], boundaries[b + 1]
        if s0 == s1:
            continue
        r, s = divmod(b, S)
        idx = order[s0:s1]
        n = s1 - s0
        out_rows[r, s, :n] = (rows[idx] - r * m_local).astype(np.int32)
        out_cols[r, s, :n] = (cols[idx] - s * k_local).astype(np.int32)
        out_vals[r, s, :n] = vals[idx]

    return KBucketedTriplets(rows=out_rows, cols=out_cols, vals=out_vals,
                             shape=(m, k), n_row_shards=R, n_k_shards=S,
                             m_local=m_local, k_local=k_local)


@dataclasses.dataclass(frozen=True)
class StackedBlockPlans:
    """Block-sparse plans (kernels/blocksparse_gpu.py) of several local
    problems, stacked along leading dims ``lead`` — (R,) row shards or
    (R, S) (row shard, k bucket) pairs — so they shard over a mesh axis
    and a ring step can ``jnp.take`` one by index.  Every local problem
    has the same row blocks; tiles pad to a common count with zero tiles
    that no row block's run reaches."""

    row_ptr: np.ndarray   # (*lead, n_row_blocks + 1) int32
    kt: np.ndarray        # (*lead, T) int32
    tiles: np.ndarray     # (*lead, T · bm, bk) f32/bf16

    shape: Tuple[int, int]   # global (M, K)
    m_local: int             # rows of each local problem (multiple of bm)
    k_local: int             # cols of each local problem
    bm: int
    bk: int

    def arrays(self):
        return self.row_ptr, self.kt, self.tiles


def _stack_block_plans(plans, lead, shape, m_local, k_local, bm, bk):
    n_tiles = max(p.n_tiles for p in plans)
    # one plan failing lossless bf16 storage makes the stack f32: the
    # stacked array shards over the mesh axis and has one dtype
    dtype = (plans[0].tiles.dtype
             if len({p.tiles.dtype for p in plans}) == 1
             else np.dtype(np.float32))
    row_ptr = np.stack([p.row_ptr for p in plans])
    kt = np.zeros((len(plans), n_tiles), np.int32)
    tiles = np.zeros((len(plans), n_tiles * bm, bk), dtype)
    for i, p in enumerate(plans):
        kt[i, :p.n_tiles] = p.kt
        tiles[i, :p.n_tiles * bm] = p.tiles.astype(dtype, copy=False)
    re = lambda x: x.reshape(*lead, *x.shape[1:])
    return StackedBlockPlans(
        row_ptr=re(row_ptr), kt=re(kt), tiles=re(tiles), shape=shape,
        m_local=m_local, k_local=k_local, bm=bm, bk=bk)


def bucket_blockplans(a, n_row_shards: int, n_k_shards: int,
                      m_align: int = 1, bm: int | None = None,
                      bk: int | None = None) -> StackedBlockPlans:
    """One block-sparse plan per (row shard, k bucket), each over the
    local problem (m_local, k_local) — rows shard-relative, cols
    bucket-relative.  ``n_k_shards`` 1 gives plain row-shard plans over
    the full K.  ``m_align`` forces m_local to a multiple of it as well
    (the reduce-scatter schedule needs m_local % n_dev == 0)."""
    from tpuspmm.kernels import blocksparse_gpu as bs

    bm = bm or bs.BM
    bk = bk or bs.BK
    rows, cols, vals, (m, k) = _to_coo_arrays(a)
    align = int(np.lcm(bm, max(int(m_align), 1)))
    m_local = round_up(cdiv(m, n_row_shards), align)
    k_local = cdiv(k, n_k_shards) if n_k_shards > 1 else k
    r_shard = rows // m_local
    k_shard = cols // k_local
    plans = []
    for r in range(n_row_shards):
        for s in range(n_k_shards):
            sel = (r_shard == r) & (k_shard == s)
            plans.append(bs.build_block_plan(
                rows[sel] - r * m_local, cols[sel] - s * k_local, vals[sel],
                (m_local, k_local), bm, bk))
    return _stack_block_plans(plans, (n_row_shards, n_k_shards), (m, k),
                              m_local, k_local, bm, bk)


def pad_dense_rows(b, k_pad: int):
    """Zero-pad B's row (K) dimension to ``k_pad`` (device arrays stay on
    device — no host round trip)."""
    import jax.numpy as jnp

    b = jnp.asarray(b, dtype=jnp.float32)
    if b.shape[0] == k_pad:
        return b
    return jnp.pad(b, ((0, k_pad - b.shape[0]), (0, 0)))
