"""XLA-level SpMM implementations (no Pallas) — gather + segment-sum.

These are the atomic-free counterparts of the reference's simplest CUDA
strategies and serve as kernel variant #1 per format in the engine registry:

- `spmm_triplets`: value-scaled gather of B rows + row segment-sum.  The
  sort-free-scatter semantics of the reference's COO atomicAdd kernel
  (reference/src/spmm/coo/spmm_coo_k1.cu:8-27) and the per-output-element
  CSR walk (reference/src/spmm/csr/spmm_csr_k1.cu:12-34) both reduce to
  this: XLA lowers the gather and the segment reduction without atomics.
- `spmm_bsr_blocks`: gathered-block batched matmul + block-row segment-sum —
  the dense-block analogue of the reference's block-row kernel
  (reference/src/spmm/bsr/spmm_bsr_k1.cu:8-41).

All functions are jit-compatible pure array functions; `num_rows`-style
sizes are static Python ints.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("num_rows",))
def spmm_triplets(rows, cols, values, b, *, num_rows: int):
    """C = scatter-add over triplets: C[rows[e]] += values[e] * B[cols[e]].

    Sentinel entries with row < 0 (ELL padding, reference
    sparse_ell.cu:12-55 uses -1) are routed to a dummy segment and dropped.
    Duplicate coordinates accumulate (COO semantics,
    reference/src/spmm/coo/spmm_coo_k1.cu:24).
    """
    rows = jnp.asarray(rows)
    safe_rows = jnp.where(rows < 0, num_rows, rows)
    # accumulate in >= f32 regardless of ingestion dtype: a bf16 B (the
    # dtype-breadth serving path) must not force bf16 accumulation
    acc = jnp.float32 if b.dtype == jnp.bfloat16 else b.dtype
    contrib = values[:, None].astype(acc) * b.astype(acc)[cols]
    out = jax.ops.segment_sum(contrib, safe_rows, num_segments=num_rows + 1)
    return out[:num_rows]


@functools.partial(jax.jit, static_argnames=("num_block_rows", "block_h", "block_w"))
def spmm_bsr_blocks(block_rows, indices, blocks, b, *, num_block_rows: int, block_h: int, block_w: int):
    """C = Σ_blocks A_block @ B_panel, segment-summed over block rows.

    `block_rows[i]` is the block-row of stored block i (expanded from
    indptr on the host).  The batched matmul is one dense batched dot.
    """
    n = b.shape[1]
    if b.dtype == jnp.bfloat16:
        b = b.astype(jnp.float32)
    b_panels = b.reshape(-1, block_w, n)[indices]  # (nblocks, bw, n)
    prod = jnp.einsum(
        "ihw,iwn->ihn", blocks, b_panels, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    safe = jnp.where(block_rows < 0, num_block_rows, block_rows)
    out = jax.ops.segment_sum(prod, safe, num_segments=num_block_rows + 1)[:num_block_rows]
    return out.reshape(num_block_rows * block_h, n)


@functools.partial(jax.jit, static_argnames=("num_rows", "num_cols"))
def spmm_densify(rows, cols, values, b, *, num_rows: int, num_cols: int):
    """Scatter A to dense on-device, then one dense matmul.

    The winning strategy at the top of the reference's synthetic density
    sweep (0.1-0.9, reference/utils/python_utils/gen_sparse.py:63-84):
    at high density a dense matmul on the densified operand beats every
    sparse decomposition.
    """
    acc = jnp.float32 if b.dtype == jnp.bfloat16 else b.dtype
    a_dense = jnp.zeros((num_rows, num_cols), dtype=acc).at[rows, cols].add(
        values.astype(acc))
    return jnp.dot(a_dense, b.astype(acc), preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)


@jax.jit
def dense_matmul(a_dense, b):
    """One dense matmul (cuBLAS) against a pre-densified (cached) A — the
    serve path of the densify variants (the scatter runs once at cache
    build, not per call).  bf16 A (stored only when lossless) times bf16
    B has exact products and f32 accumulation; anything else runs in f32
    at HIGHEST (true f32, not TF32)."""
    if a_dense.dtype == jnp.bfloat16 and b.dtype == jnp.bfloat16:
        return jnp.dot(a_dense, b, preferred_element_type=jnp.float32)
    return jnp.dot(a_dense.astype(jnp.float32), b.astype(jnp.float32),
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def spmm_densify_cached(a, b):
    """Container-level densify strategy: A is static across serving
    calls, so densify ONCE on the host (f64 accumulate — duplicates
    fold deterministically), cache the f32 dense operand on the COO
    view, and serve one dense matmul per call.  f64 operands keep
    the scatter-per-call path so the accumulator follows the operand."""
    b = jnp.asarray(b)
    coo = coo_view(a)
    if b.dtype == jnp.float64:
        rows, cols, vals = _cached_device(
            coo, "triplets",
            lambda: (jnp.asarray(np.asarray(coo.rows)),
                     jnp.asarray(np.asarray(coo.cols)),
                     jnp.asarray(np.asarray(coo.values))),
        )
        return spmm_densify(rows, cols, vals, b,
                            num_rows=a.shape[0], num_cols=a.shape[1])

    def _build():
        from tpuspmm.kernels.blocksparse_gpu import values_bf16_exact

        rows = np.asarray(coo.rows)
        cols = np.asarray(coo.cols)
        vals = np.asarray(coo.values, dtype=np.float64)
        dense = np.zeros(a.shape, np.float64)
        np.add.at(dense, (rows, cols), vals)  # duplicates accumulate
        dense = dense.astype(np.float32)
        if values_bf16_exact(dense):
            dense = dense.astype(jnp.bfloat16)
        return jnp.asarray(dense)

    return dense_matmul(_cached_device(coo, "dense", _build), b)


def expand_indptr(indptr: np.ndarray, nnz: int) -> np.ndarray:
    """Host-side CSR indptr → per-entry row ids (static preprocessing)."""
    indptr = np.asarray(indptr)
    return np.repeat(
        np.arange(len(indptr) - 1, dtype=np.int32), np.diff(indptr).astype(np.int64)
    )[:nnz]


# --------------------------------------------------------------------------
# Container-level wrappers (host preprocessing + jit compute)
# --------------------------------------------------------------------------

def _cached_device(a, key: str, build):
    """Transfer-once cache attached to the immutable container (same
    mechanism as BlockPlan.device_arrays — steady-state serving must not
    re-pay H2D per call)."""
    cache = getattr(a, "_xla_cache", None)
    if cache is None:
        cache = {}
        try:
            object.__setattr__(a, "_xla_cache", cache)
        except Exception:
            return build()
    if key not in cache:
        import jax

        built = build()
        leaves = jax.tree_util.tree_leaves(built)
        if any(isinstance(x, jax.core.Tracer) for x in leaves):
            # built under a trace (e.g. inside a chained timing loop):
            # caching trace-scoped tracers would leak them into later
            # traces — serve without caching
            return built
        cache[key] = built
    return cache[key]


def coo_view(a):
    """COO triplet view of any container, cached on the (immutable)
    container — repeated auto-path calls must not re-pay the format
    conversion or the H2D transfer of the triplets (the `_cached_device`
    arrays attach to this view, so it has to be a stable object)."""
    if a.format_name == "coo":
        return a
    cached = getattr(a, "_coo_view", None)
    if cached is None:
        cached = a.to_coo() if hasattr(a, "to_coo") else a.to_csr().to_coo()
        try:
            object.__setattr__(a, "_coo_view", cached)
        except Exception:
            pass
    return cached


def spmm_csr_xla(a, b):
    def build():
        rows = expand_indptr(np.asarray(a.indptr), a.nnz)
        return (jnp.asarray(rows), jnp.asarray(a.indices), jnp.asarray(a.values))

    rows, cols, vals = _cached_device(a, "triplets", build)
    return spmm_triplets(rows, cols, vals, jnp.asarray(b), num_rows=a.shape[0])


def spmm_coo_xla(a, b):
    rows, cols, vals = _cached_device(
        a, "triplets",
        lambda: (jnp.asarray(a.rows), jnp.asarray(a.cols), jnp.asarray(a.values)),
    )
    return spmm_triplets(rows, cols, vals, jnp.asarray(b), num_rows=a.shape[0])


def spmm_bsr_xla(a, b):
    def build():
        block_rows = expand_indptr(np.asarray(a.indptr), a.nblocks)
        return (jnp.asarray(block_rows), jnp.asarray(a.indices), jnp.asarray(a.blocks))

    block_rows, indices, blocks = _cached_device(a, "blocks", build)
    return spmm_bsr_blocks(
        block_rows, indices, blocks, jnp.asarray(b),
        num_block_rows=a.num_block_rows, block_h=a.block_size[0], block_w=a.block_size[1],
    )


def spmm_ell_xla(a, b):
    """Column-major ELL: slot (j, k) contributes values[j,k] * B[j] to row
    rowind[j,k] — flattened into triplets with -1 sentinels preserved."""

    def build():
        ncols, mcn = a.rowind.shape
        cols = np.repeat(np.arange(ncols, dtype=np.int32), mcn)
        return (
            jnp.asarray(np.asarray(a.rowind).ravel()),
            jnp.asarray(cols),
            jnp.asarray(np.asarray(a.values).ravel()),
        )

    rows, cols, vals = _cached_device(a, "triplets", build)
    return spmm_triplets(rows, cols, vals, jnp.asarray(b), num_rows=a.shape[0])
