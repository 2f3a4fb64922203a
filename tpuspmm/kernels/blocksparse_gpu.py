"""Block-sparse SpMM for Hopper through Pallas on the Triton route.

The static sparse operand is densified once, at plan time, into dense
(bm × bk) tiles: one tile per occupied (row block, k-tile) pair, tiles
sorted by row block, with ``row_ptr`` giving each row block's run of
tiles (a CSR over tiles).  Serving is then a stream of small dense
products:

    for each program (row block i, column tile j), in parallel:
        acc = 0                                    # (bm, bn) registers
        for t in row_ptr[i] .. row_ptr[i+1]:       # variable-length run
            acc += tiles[t] @ B[kt[t]·bk : +bk, j·bn : +bn]
        C[i·bm : +bm, j·bn : +bn] = acc            # written once

Nothing carries across programs.  The plain XLA version of the same plan
(``bench/kernel_compare.py``) gathers every tile's B rows into a
(n_tiles, bk, N) array in device memory, runs one batched product and
segment-sums by row block; the kernel keeps the gathered B tile in
shared memory and the partial sums in registers.

A plan stores 4·bm·bk bytes (2· when bf16) per occupied tile, however
few nonzeros the tile holds: :func:`plan_stats` gives its size and fill
from the triplets alone, so the dispatcher can refuse a scattered matrix
before any tile is built.

Precision of every ``pl.dot``: operands are bf16 and products accumulate
in f32.  Tiles store bf16 when every value round-trips bf16 losslessly
(±1 incidence matrices); f32 data goes through the bf16 split ladder of
:func:`tpuspmm.kernels.common.split_bf16` — 3 terms per f32 operand,
with every cross term whose order is below 2^-24 dropped — so the
product is float32-exact in the same sense as an IEEE f32 FMA loop, at
tensor-core rate:

    bf16 tiles × bf16 B   1 dot   (exact products)
    bf16 tiles × f32 B    3 dots  (B split 3 ways)
    f32 tiles × bf16 B    3 dots  (tile split 3 ways)
    f32 tiles × f32 B     6 dots  (both split, terms of order ≥ 2^-16)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tpuspmm.config import should_interpret
from tpuspmm.kernels.common import cdiv, round_up, split_bf16

# Tile geometry, chosen on an H100 SXM (PERF.md): 64 × 64 tiles with a
# 128-wide output tile and 4 warps served the Llama-2-7B-shaped 90%
# 4×4-block weight fastest, or within run-to-run noise of the fastest,
# among seven geometries (bm, bk ∈ 16..128).  Powers of two, ≥ 16 (the
# Triton dot's minimum).
BM = 64
BK = 64
BN_MAX = 128
NUM_WARPS = 4
NUM_STAGES = 2
# the precision of every dot in the kernel: bf16 operands, products exact
# in f32, f32 accumulation
BF16_DOT = jax.lax.DotAlgorithmPreset.BF16_BF16_F32


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """A sparse matrix densified into (bm × bk) tiles, row-block-major."""

    row_ptr: np.ndarray  # (n_row_blocks + 1,) int32 — tile run per row block
    rb: np.ndarray       # (n_tiles,) int32 — row block of each tile
    kt: np.ndarray       # (n_tiles,) int32 — k-tile of each tile
    tiles: np.ndarray    # (n_tiles · bm, bk) f32, or bf16 when lossless
    shape: Tuple[int, int]
    bm: int
    bk: int
    nnz: int             # stored nonzeros (duplicates summed)

    @property
    def n_tiles(self) -> int:
        return int(self.kt.shape[0])

    @property
    def n_row_blocks(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    @property
    def plan_bytes(self) -> int:
        return int(self.tiles.nbytes)

    @property
    def fill(self) -> float:
        """Share of stored tile entries that are nonzeros."""
        slots = self.n_tiles * self.bm * self.bk
        return self.nnz / slots if slots else 0.0

    def device_arrays(self):
        """(row_ptr, rb, kt, tiles) on device — transferred once, cached."""
        cached = getattr(self, "_device_arrays", None)
        if cached is None:
            cached = tuple(jnp.asarray(x) for x in
                           (self.row_ptr, self.rb, self.kt, self.tiles))
            if any(isinstance(x, jax.core.Tracer) for x in cached):
                return cached  # built under a trace: do not leak tracers
            object.__setattr__(self, "_device_arrays", cached)
        return cached


def values_bf16_exact(vals) -> bool:
    """Do these f32 values round-trip bf16 losslessly?"""
    v = np.asarray(vals, np.float32)
    return bool(np.array_equal(
        v.astype(ml_dtypes.bfloat16).astype(np.float32), v))


def dedupe_triplets(rows, cols, vals, k: int):
    """Collapse duplicate coordinates, summing in f64 then rounding to
    f32 (COO duplicate-accumulate semantics, deterministic).  After this
    every plan slot holds exactly one value."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    if not len(rows):
        return rows, cols, vals
    key = rows * np.int64(k) + cols
    uniq, inv = np.unique(key, return_inverse=True)
    if len(uniq) == len(rows):
        return rows, cols, vals
    acc = np.zeros(len(uniq), np.float64)
    np.add.at(acc, inv, vals.astype(np.float64))
    return uniq // k, uniq % k, acc.astype(np.float32)


def build_block_plan(rows, cols, vals, shape: Tuple[int, int],
                     bm: int = BM, bk: int = BK) -> BlockPlan:
    """Group the triplets by (row block, k-tile) and densify each group
    into one (bm × bk) tile.  Row blocks with no tile get an empty run."""
    m, k = shape
    rows, cols, vals = dedupe_triplets(rows, cols, vals, k)
    dtype = ml_dtypes.bfloat16 if values_bf16_exact(vals) else np.float32
    n_rb = max(1, cdiv(m, bm))
    nkt = max(1, cdiv(k, bk))
    rb, kt = rows // bm, cols // bk
    key = rb * nkt + kt
    uniq, tile_of = np.unique(key, return_inverse=True)
    if not len(uniq):
        # one zero tile that no row block's run reaches keeps every
        # array non-empty
        uniq = np.zeros(1, np.int64)
    t_rb = (uniq // nkt).astype(np.int32)
    row_ptr = np.searchsorted(t_rb, np.arange(n_rb + 1)).astype(np.int32)
    if not len(rows):
        row_ptr[:] = 0
    tiles = np.zeros((len(uniq), bm, bk), dtype)
    tiles[tile_of, rows - rb * bm, cols - kt * bk] = vals.astype(dtype)
    return BlockPlan(row_ptr=row_ptr, rb=t_rb,
                     kt=(uniq % nkt).astype(np.int32),
                     tiles=tiles.reshape(-1, bk), shape=(int(m), int(k)),
                     bm=bm, bk=bk, nnz=int(len(rows)))


def block_plan(a) -> BlockPlan:
    """Build (or fetch the plan cached on the container) for any format."""
    from tpuspmm.ops.xla import _cached_device, coo_view

    coo = coo_view(a)
    return _cached_device(
        coo, "block_plan",
        lambda: build_block_plan(np.asarray(coo.rows), np.asarray(coo.cols),
                                 np.asarray(coo.values), coo.shape))


@dataclasses.dataclass(frozen=True)
class PlanStats:
    """What :func:`block_plan` would build, without building it."""

    n_tiles: int
    nnz: int
    plan_bytes: int

    @property
    def fill(self) -> float:
        slots = self.n_tiles * BM * BK
        return self.nnz / slots if slots else 0.0


def plan_stats(a) -> PlanStats:
    """Tile count, fill and bytes of the container's plan, in O(nnz) from
    the unique (row block, k-tile) keys (cached on the container)."""
    from tpuspmm.ops.xla import _cached_device, coo_view

    def build():
        m, k = coo.shape
        rows, cols, vals = dedupe_triplets(np.asarray(coo.rows),
                                           np.asarray(coo.cols),
                                           np.asarray(coo.values), k)
        nkt = max(1, cdiv(k, BK))
        n_tiles = max(1, len(np.unique((rows // BM) * nkt + cols // BK)))
        itemsize = 2 if values_bf16_exact(vals) else 4
        return PlanStats(n_tiles=n_tiles, nnz=int(len(rows)),
                         plan_bytes=n_tiles * BM * BK * itemsize)

    coo = coo_view(a)
    return _cached_device(coo, "plan_stats", build)


def pick_bn(n: int) -> int:
    """Output column tile: the whole width up to BN_MAX, a power of two."""
    return min(BN_MAX, max(16, pl.next_power_of_2(n)))


def n_programs(m: int, n: int) -> int:
    """The kernel's grid size for an (m × ·) plan at width n."""
    return max(1, cdiv(m, BM)) * cdiv(n, pick_bn(n))


def _split_dot(a, b):
    """f32-accurate product of two tiles as bf16 tensor-core dots (see
    the module docstring for the ladder)."""
    a_parts = [a] if a.dtype == jnp.bfloat16 else split_bf16(a, 3)
    b_parts = [b] if b.dtype == jnp.bfloat16 else split_bf16(b, 3)
    acc = None
    for i, ap in enumerate(a_parts):
        for j, bp in enumerate(b_parts):
            if i + j < max(len(a_parts), len(b_parts)):
                d = pl.dot(ap, bp, precision=BF16_DOT)
                acc = d if acc is None else acc + d
    return acc


def _kernel(row_ptr_ref, kt_ref, tiles_ref, b_ref, o_ref, *,
            bm, bk, bn, k, n):
    i = pl.program_id(0)
    j = pl.program_id(1)
    cols = j * bn + jnp.arange(bn)
    col_ok = cols < n

    def body(t, acc):
        a = tiles_ref[pl.ds(t * bm, bm), :]
        k0 = kt_ref[t] * bk
        krows = k0 + jnp.arange(bk)
        mask = (krows < k)[:, None] & col_ok[None, :]
        b = plgpu.load(b_ref.at[pl.ds(k0, bk), pl.ds(j * bn, bn)],
                       mask=mask, other=0)
        return acc + _split_dot(a, b)

    acc = jax.lax.fori_loop(row_ptr_ref[i], row_ptr_ref[i + 1], body,
                            jnp.zeros((bm, bn), jnp.float32))
    o_ref[...] = acc


@functools.partial(jax.jit, static_argnames=("m_pad", "bm", "bk",
                                             "interpret"))
def blocksparse_call(row_ptr, kt, tiles, b, *, m_pad, bm, bk,
                     interpret=False):
    """One launch of the kernel: C (m_pad × n_pad) for a plan's device
    arrays and an unpadded B (rows past K and columns past N are masked
    in the kernel).  Callers slice C to (M, N)."""
    k, n = b.shape
    bn = pick_bn(n)
    n_pad = round_up(n, bn)
    return pl.pallas_call(
        functools.partial(_kernel, bm=bm, bk=bk, bn=bn, k=k, n=n),
        out_shape=jax.ShapeDtypeStruct((m_pad, n_pad), jnp.float32),
        grid=(row_ptr.shape[0] - 1, n_pad // bn),
        in_specs=[pl.no_block_spec] * 4,
        out_specs=pl.BlockSpec((bm, bn), lambda i, j: (i, j)),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name="blocksparse_spmm",
    )(row_ptr, kt, tiles, b)


def runnable(interpret=None) -> bool:
    """The kernel runs compiled on a GPU, or interpreted when asked."""
    from tpuspmm.config import platform

    return should_interpret(interpret) or platform() == "gpu"


def spmm_blocksparse(a_or_plan, b, interpret=None):
    """C = A @ B through the block-sparse kernel (plan built and cached
    on the container at first use)."""
    plan = (a_or_plan if isinstance(a_or_plan, BlockPlan)
            else block_plan(a_or_plan))
    interp = should_interpret(interpret)
    if not runnable(interp):
        raise RuntimeError(
            "the block-sparse Triton kernel needs a GPU; pass "
            "interpret=True (or set TPUSPMM_INTERPRET=1) to interpret it")
    b = jnp.asarray(b)
    if b.dtype not in (jnp.float32, jnp.bfloat16):
        b = b.astype(jnp.float32)
    m, _ = plan.shape
    n = int(b.shape[1])
    row_ptr, _, kt, tiles = plan.device_arrays()
    out = blocksparse_call(row_ptr, kt, tiles, b,
                           m_pad=plan.n_row_blocks * plan.bm, bm=plan.bm,
                           bk=plan.bk, interpret=interp)
    return out[:m, :n]
