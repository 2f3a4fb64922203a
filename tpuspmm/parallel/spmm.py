"""Distributed SpMM schedules over a device mesh.

Schedules, in increasing communication sophistication:

- ``spmm_row_sharded`` — A row-sharded over ``"rows"``, B replicated.
  Zero collectives in the forward pass; each device runs the single-device
  local compute on its slab.  The weak-scaling workhorse: nnz/s should
  scale ~linearly with devices.

- ``spmm_2d`` — A row-sharded over ``"rows"``, B column-sharded over
  ``"cols"`` (replicated over ``"rows"``).  Output is sharded over both
  axes.  Still collective-free; memory per device drops by the mesh area.

- ``spmm_ring`` — A row-sharded AND k-bucketed, B row(K)-sharded: no
  device ever holds all of B.  B panels travel around the ``"rows"`` ring
  via ``ppermute`` while each device multiplies the bucket matching the
  panel it currently holds.  XLA schedules the ppermute concurrently with
  the bucket compute (the send uses only the incoming panel, not the
  accumulator).

- ``spmm_kshard`` — A column-partitioned along K; full-height partial
  outputs combined with a ``psum_scatter`` that leaves C row-sharded.

Every schedule takes ``local``: ``"xla"`` (gather + segment-sum, the
default) or ``"blocksparse"`` (the Triton block-sparse kernel on each
device's plan; on a GPU, or interpreted when asked).  The mesh follows
the algorithm alone: the devices of one host reach each other at one rate.

The reference has no distributed execution at all (SURVEY.md §0, §2.4:
single hard-coded GPU at reference/src/main.cu:176); these are new-build
capabilities.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuspmm.config import should_interpret
from tpuspmm.kernels.common import round_up
from tpuspmm.ops.xla import spmm_triplets
from tpuspmm.parallel.shard import (
    KBucketedTriplets,
    StackedBlockPlans,
    shard_rows_tileplan,
    bucket_triplets,
    bucket_blockplans,
    pad_dense_rows,
)

LOCALS = ("xla", "blocksparse")


def _put(mesh: Mesh, x, spec: P):
    return jax.device_put(x, NamedSharding(mesh, spec))


def _check_local(local: str, schedule: str) -> None:
    if local not in LOCALS:
        raise ValueError(f"{schedule} local must be one of {LOCALS}, "
                         f"got {local!r}")


def _cached_plan(a, key, build):
    """Container-level plan cache shared by every schedule (containers
    that refuse __setattr__ just rebuild)."""
    cache = getattr(a, "_plan_cache", None)
    if cache is None:
        cache = {}
        try:
            object.__setattr__(a, "_plan_cache", cache)
        except Exception:
            cache = None
    if cache is not None and key in cache:
        return cache[key]
    plans = build()
    if cache is not None:
        cache[key] = plans
    return plans


def _cached_blockplans(a, n_row, n_k, m_align=1) -> StackedBlockPlans:
    return _cached_plan(a, ("blockplans", n_row, n_k, m_align),
                        lambda: bucket_blockplans(a, n_row, n_k,
                                                  m_align=m_align))


def _blocksparse_local(w, b, *, m_local, bm, bk, interpret):
    """The block-sparse kernel on one device's plan arrays ``w`` (each with
    its stacked leading dims already indexed away)."""
    from tpuspmm.kernels import blocksparse_gpu as bs

    out = bs.blocksparse_call(*w, b, m_pad=round_up(m_local, bm), bm=bm,
                              bk=bk, interpret=interpret)
    return out[:m_local, :b.shape[1]]


def _tileplan_triplets(rt, kt, rows, cols, vals, tm, tk):
    """The row-sharded tile plan read as triplets (tile-local coordinates
    shifted to slab coordinates; padding rows stay -1 and are dropped)."""
    gr = jnp.where(rows < 0, -1, rows + rt.astype(jnp.int32)[:, None] * tm)
    gc = cols + kt.astype(jnp.int32)[:, None] * tk
    return gr.reshape(-1), gc.reshape(-1), vals.reshape(-1)


# ---------------------------------------------------------------------------
# row-sharded, B replicated / 2-D: rows × cols
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _rows_xla_callable(mesh, row_axis, b_spec, out_spec, m_local, tm, tk):
    def local_fn(rt, kt, rows, cols, vals, b):
        gr, gc, v = _tileplan_triplets(rt[0], kt[0], rows[0], cols[0],
                                       vals[0], tm, tk)
        return spmm_triplets(gr, gc, v, b, num_rows=m_local)

    return jax.jit(jax.shard_map(
        local_fn, mesh=mesh, in_specs=(P(row_axis),) * 5 + (b_spec,),
        out_specs=out_spec, check_vma=False))


@functools.lru_cache(maxsize=64)
def _rows_blocksparse_callable(mesh, row_axis, b_spec, out_spec, m_local,
                               bm, bk, interpret):
    def local_fn(*args):
        *w, b = args
        return _blocksparse_local([x[0, 0] for x in w], b, m_local=m_local,
                                  bm=bm, bk=bk, interpret=interpret)

    return jax.jit(jax.shard_map(
        local_fn, mesh=mesh, in_specs=(P(row_axis),) * 3 + (b_spec,),
        out_specs=out_spec, check_vma=False))


def _spmm_rows(a, b, mesh, row_axis, b_spec, out_spec, n_col_shards, local,
               plan, interpret):
    """Shared body of the row-sharded and 2-D schedules: A row-sharded
    over ``row_axis``, B laid out by ``b_spec``."""
    n_dev = mesh.shape[row_axis]
    n = int(np.shape(b)[1])
    shard = functools.partial(_put, mesh)
    if local == "blocksparse":
        plans = plan or _cached_blockplans(a, n_dev, 1)
        m = plans.shape[0]
        n_pad = round_up(n, n_col_shards)
        b_pad = pad_dense_rows(b, plans.shape[1])
        if n_pad != n:
            b_pad = jnp.pad(b_pad, ((0, 0), (0, n_pad - n)))
        args = [shard(x, P(row_axis)) for x in plans.arrays()]
        fn = _rows_blocksparse_callable(
            mesh, row_axis, b_spec, out_spec, plans.m_local, plans.bm,
            plans.bk, should_interpret(interpret))
        return fn(*args, shard(b_pad, b_spec))[:m, :n]
    plan = plan or shard_rows_tileplan(a, n_dev)
    m = plan.shape[0]
    n_pad = round_up(n, n_col_shards)
    b_pad = pad_dense_rows(b, plan.num_k_tiles * plan.tile_k)
    if n_pad != n:
        b_pad = jnp.pad(b_pad, ((0, 0), (0, n_pad - n)))
    args = [shard(x, P(row_axis)) for x in
            (plan.rt, plan.kt, plan.rows, plan.cols, plan.vals)]
    fn = _rows_xla_callable(mesh, row_axis, b_spec, out_spec, plan.m_local,
                            plan.tile_m, plan.tile_k)
    return fn(*args, shard(b_pad, b_spec))[:m, :n]


def spmm_row_sharded(a, b, mesh: Mesh, axis: str = "rows",
                     local: str = "xla", plan=None, interpret=None):
    """C = A @ B with A row-sharded over ``axis`` and B replicated.

    ``plan``: a prebuilt RowShardedPlan (``local="xla"``) or
    StackedBlockPlans from ``bucket_blockplans(a, n_dev, 1)``
    (``local="blocksparse"``)."""
    _check_local(local, "spmm_row_sharded")
    return _spmm_rows(a, b, mesh, axis, P(), P(axis), 1, local, plan,
                      interpret)


def spmm_2d(a, b, mesh: Mesh, plan=None, interpret=None, local: str = "xla"):
    """C = A @ B on a 2-D mesh: A sharded over "rows", B over "cols".

    ``local`` selects the per-shard compute like spmm_row_sharded; each
    shard sees only its column block of B."""
    _check_local(local, "spmm_2d")
    return _spmm_rows(a, b, mesh, "rows", P(None, "cols"),
                      P("rows", "cols"), mesh.shape["cols"], local, plan,
                      interpret)


# ---------------------------------------------------------------------------
# K-sharded: A column-partitioned, partial outputs reduce-scattered
# ---------------------------------------------------------------------------

def spmm_kshard(a, b, mesh: Mesh, axis: str = "rows",
                buckets: Optional[KBucketedTriplets] = None,
                local: str = "xla",
                plans: Optional[StackedBlockPlans] = None,
                interpret=None):
    """C = A @ B with the *contraction* dimension sharded.

    Each device owns a column slab of A and the matching K-rows of B,
    computes a full-height partial C, and a ``psum_scatter`` over the
    mesh axis both reduces the partials and leaves C row-sharded — the
    reduce-scatter decomposition, complementary to the ring schedule
    (which keeps A row-sharded and moves B instead).

    ``buckets`` (``local="xla"``) or ``plans`` (``local="blocksparse"``,
    from ``bucket_blockplans(a, 1, n_dev, m_align=n_dev)``) may be
    prebuilt."""
    _check_local(local, "spmm_kshard")
    n_dev = mesh.shape[axis]
    n_orig = int(np.shape(b)[1])
    shard = functools.partial(_put, mesh)
    if local == "blocksparse":
        if buckets is not None:
            raise ValueError("spmm_kshard(local='blocksparse') takes "
                             "prebuilt plans=, not triplet buckets=")
        plans = plans or _cached_blockplans(a, 1, n_dev, m_align=n_dev)
        if plans.row_ptr.shape[:2] != (1, n_dev):
            raise ValueError("spmm_kshard needs plans from "
                             "bucket_blockplans(a, 1, n_dev, m_align=n_dev)")
        if plans.m_local % n_dev:
            raise ValueError(f"m_local={plans.m_local} not divisible by "
                             f"{n_dev}; rebuild with m_align={n_dev}")
        b_pad = pad_dense_rows(b, plans.k_local * n_dev)
        args = [shard(x[0], P(axis)) for x in plans.arrays()]
        fn = _kshard_blocksparse_callable(mesh, axis, plans.m_local,
                                          plans.bm, plans.bk,
                                          should_interpret(interpret))
        return fn(*args, shard(b_pad, P(axis)))[:plans.shape[0], :n_orig]
    if plans is not None:
        raise ValueError("spmm_kshard(local='xla') takes prebuilt "
                         "buckets=, not block plans=")
    if buckets is None:
        # single row shard, K bucketed: buckets.rows is (1, S, E)
        buckets = bucket_triplets(a, 1, n_dev, m_align=8 * n_dev)
    # ring-style buckets (n_row_shards > 1) would silently drop every row
    # shard after the first, and the psum_scatter needs an even row split
    if buckets.n_row_shards != 1:
        raise ValueError(
            f"spmm_kshard needs K-bucketed triplets (n_row_shards == 1), "
            f"got {buckets.n_row_shards}; rebuild with bucket_triplets(a, 1, n_dev)")
    if buckets.m_local % n_dev != 0:
        raise ValueError(
            f"m_local={buckets.m_local} not divisible by mesh axis size "
            f"{n_dev}; rebuild buckets with m_align={8 * n_dev}")
    m, k = buckets.shape
    b_padded = pad_dense_rows(b, buckets.k_local * n_dev)
    args = (
        shard(buckets.rows[0], P(axis)),   # (S, E) → local (1, E)
        shard(buckets.cols[0], P(axis)),
        shard(buckets.vals[0], P(axis)),
        shard(b_padded, P(axis)),
    )
    fn = _kshard_callable(mesh, axis, buckets.m_local)
    out = fn(*args)
    return out[:m, :n_orig]


@functools.lru_cache(maxsize=64)
def _kshard_callable(mesh, axis, m_pad):
    def local_fn(rows, cols, vals, b_panel):
        partial = spmm_triplets(rows[0], cols[0], vals[0], b_panel,
                                num_rows=m_pad)
        return jax.lax.psum_scatter(partial, axis, scatter_dimension=0,
                                    tiled=True)

    return jax.jit(jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
    ))


@functools.lru_cache(maxsize=64)
def _kshard_blocksparse_callable(mesh, axis, m_local, bm, bk, interpret):
    def local_fn(*args):
        *w, b_panel = args
        partial = _blocksparse_local([x[0] for x in w], b_panel,
                                     m_local=m_local, bm=bm, bk=bk,
                                     interpret=interpret)
        return jax.lax.psum_scatter(partial, axis, scatter_dimension=0,
                                    tiled=True)

    return jax.jit(jax.shard_map(
        local_fn, mesh=mesh, in_specs=(P(axis),) * 4, out_specs=P(axis),
        check_vma=False))


# ---------------------------------------------------------------------------
# ring: B K-sharded, panels ppermuted around the mesh axis
# ---------------------------------------------------------------------------

def spmm_ring(a, b, mesh: Mesh, axis: str = "rows",
              cols_axis: Optional[str] = None,
              buckets: Optional[KBucketedTriplets] = None,
              local: str = "xla",
              plans: Optional[StackedBlockPlans] = None,
              interpret=None):
    """C = A @ B with B sharded along K; panels travel around the ring.

    Device d starts with panel d.  At ring step i it holds panel
    ``src = (d - i) mod n`` and multiplies bucket ``src`` of its row slab
    against it while ``ppermute`` forwards the panel to ``d + 1``.  After n
    steps every bucket has met its panel; the accumulator is the local C
    slab.  Communication volume per device: (n-1)/n of B, pipelined.

    ``cols_axis`` (optional) also column-shards B and C; the ring then
    runs independently inside each column group.  ``buckets``
    (``local="xla"``) or ``plans`` (``local="blocksparse"``, from
    ``bucket_blockplans(a, n_dev, n_dev)``) may be prebuilt."""
    _check_local(local, "spmm_ring")
    n_dev = mesh.shape[axis]
    n_orig = int(np.shape(b)[1])
    if local == "blocksparse":
        if buckets is not None:
            raise ValueError("spmm_ring(local='blocksparse') takes "
                             "prebuilt plans=, not triplet buckets=")
        plans = plans or _cached_blockplans(a, n_dev, n_dev)
        m, k_local, m_local = plans.shape[0], plans.k_local, plans.m_local
    else:
        if plans is not None:
            raise ValueError("spmm_ring(local='xla') takes prebuilt "
                             "buckets=, not block plans=")
        buckets = buckets or bucket_triplets(a, n_dev, n_dev)
        m, k_local, m_local = buckets.shape[0], buckets.k_local, buckets.m_local
    b_padded = pad_dense_rows(b, k_local * n_dev)
    n = b_padded.shape[1]
    if cols_axis is not None:
        n_cols = mesh.shape[cols_axis]
        n_pad = -(-n // n_cols) * n_cols
        if n_pad != n:
            b_padded = jnp.pad(b_padded, ((0, 0), (0, n_pad - n)))
        b_spec = P(axis, cols_axis)
    else:
        b_spec = P(axis)

    shard = functools.partial(_put, mesh)
    if local == "blocksparse":
        args = [shard(x, P(axis)) for x in plans.arrays()]
        fn = _ring_callable(mesh, axis, cols_axis, n_dev, m_local, local,
                            (plans.bm, plans.bk, should_interpret(interpret)))
    else:
        args = [shard(x, P(axis)) for x in
                (buckets.rows, buckets.cols, buckets.vals)]
        fn = _ring_callable(mesh, axis, cols_axis, n_dev, m_local, local,
                            None)
    out = fn(*args, shard(b_padded, b_spec))
    return out[:m, :n_orig]


@functools.lru_cache(maxsize=64)
def _ring_callable(mesh, axis, cols_axis, n_dev, m_local, local, kernel):
    perm = tuple((j, (j + 1) % n_dev) for j in range(n_dev))
    vary_axes = (axis,) if cols_axis is None else (axis, cols_axis)
    b_spec = P(axis) if cols_axis is None else P(axis, cols_axis)

    def bucket_product(bucket, b_cur):
        if local == "blocksparse":
            bm, bk, interpret = kernel
            return _blocksparse_local(bucket, b_cur, m_local=m_local, bm=bm,
                                      bk=bk, interpret=interpret)
        r, c, v = bucket
        return spmm_triplets(r, c, v, b_cur, num_rows=m_local)

    def local_fn(*args):
        *stacks, b_panel = args
        stacks = [x[0] for x in stacks]  # drop the shard dim: (S, ...)
        idx = jax.lax.axis_index(axis)
        # the accumulator joins a carry with mesh-varying b_panel
        acc0 = jax.lax.pcast(
            jnp.zeros((m_local, b_panel.shape[1]), jnp.float32),
            vary_axes, to="varying")

        def body(i, carry):
            b_cur, acc = carry
            src = (idx - i) % n_dev
            bucket = [jnp.take(x, src, axis=0) for x in stacks]
            # the send depends only on b_cur — XLA overlaps it with compute
            b_nxt = jax.lax.ppermute(b_cur, axis, list(perm))
            return (b_nxt, acc + bucket_product(bucket, b_cur))

        _, acc = jax.lax.fori_loop(0, n_dev, body, (b_panel, acc0))
        return acc

    n_stacks = 3
    return jax.jit(jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(axis),) * n_stacks + (b_spec,),
        out_specs=b_spec if cols_axis is not None else P(axis),
        check_vma=False,
    ))
