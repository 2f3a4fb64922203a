"""Compensated (error-free-transformation) SpMM for extreme-value matrices.

The reference guarantees its oracle comparison by accumulating in double
(reference/src/main.cu:185); this library computes in f32 (an f64
accumulator is a later alternative, ROADMAP Design 3).  For matrices
with huge dynamic range (the corpus's medium_1484/2880/4000 carry
|values| up to ~1e7) a single f32 product already rounds by up to
eps*|a*b| ~ 1e0 — far beyond the abs-1e-3 gate — so on outputs where the
row's products cancel, EVERY plain-f32 strategy (tile-ordered or
row-ordered) passes or fails by luck of the operand (medium_2880 misses
by ~0.03 under one summation order and passes by ~0.001 under another).

This module makes the gate deterministic with pure-f32 error-free
transformations:

- Dekker/Veltkamp two-product: p = fl(a*b) plus the EXACT residual
  e = a*b - p, via 12+12-bit operand splits (all f32 ops, no FMA needed).
- Knuth TwoSum: s = fl(x+y) plus the exact residual, so the running
  accumulation is a double-f32 ("double-single") number.

The true row sum is Σ(p_i + e_i) exactly; accumulating p_i with TwoSum
and folding the residuals + e_i into a compensation term leaves a final
error of O(eps*|result| + n*eps^2*Σ|p_i|) — orders of magnitude inside
the rel-1e-2/abs-1e-3 gate for any operand, independent of summation
order.  Cost: one (m, W, n)-shaped pass (W = max row nnz) of elementwise work —
reserved for matrices that need it (``needs_compensated``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Above this |value|, one f32 product's rounding (eps ~ 6e-8 relative)
# can exceed the absolute gate tolerance 1e-3 even for O(1) dense
# operands: 6e-8 * 2e4 > 1e-3.  Matrices beyond it get the compensated
# path for their gate-exact tier.
EXTREME_ABS_VALUE = 2.0e4

# Affordability caps: the compensated pass materializes (m, W) slot
# arrays (W = max row nnz, 8 B/slot for colidx+vals) and does O(m*W*n)
# elementwise work, so one pathological heavy row must not reroute a huge matrix
# here — the dispatcher falls through to the nnz-proportional strategies
# (which still per-run verify) when these caps are exceeded.
EXACT_MAX_SLOT_BYTES = 256 * 1024 * 1024
EXACT_MAX_PAD_RATIO = 32.0


def needs_compensated(a) -> bool:
    """True when plain-f32 products can breach the abs-1e-3 gate for this
    matrix (detected once at plan time, cached on the container)."""
    cached = getattr(a, "_max_abs_value", None)
    if cached is None:
        vals = np.asarray(a.values if hasattr(a, "values") else a.blocks)
        cached = float(np.max(np.abs(vals))) if vals.size else 0.0
        try:
            object.__setattr__(a, "_max_abs_value", cached)
        except Exception:
            pass
    return cached > EXTREME_ABS_VALUE


def _max_row_nnz(a) -> int:
    """Cheap W = max nnz per row, from container metadata (no slot-array
    materialization); cached on the container."""
    cached = getattr(a, "_max_row_nnz", None)
    if cached is not None:
        return cached
    fmt = getattr(a, "format_name", "")
    if fmt == "csr":
        ip = np.asarray(a.indptr, dtype=np.int64)
        w = int(np.diff(ip).max()) if len(ip) > 1 else 0
    elif fmt == "bsr":
        # upper bound: densest block-row fully dense across its blocks
        ip = np.asarray(a.indptr, dtype=np.int64)
        blen = int(np.diff(ip).max()) if len(ip) > 1 else 0
        w = blen * a.block_size[1]
    elif hasattr(a, "rows"):  # COO
        r = np.asarray(a.rows)
        w = int(np.bincount(r, minlength=a.shape[0]).max()) if r.size else 0
    else:  # ELL (col-major) and anything else: count via COO view
        coo = a.to_coo()
        r = np.asarray(coo.rows)
        w = int(np.bincount(r, minlength=a.shape[0]).max()) if r.size else 0
    try:
        object.__setattr__(a, "_max_row_nnz", w)
    except Exception:
        pass
    return w


def exact_admissible(a) -> bool:
    """True when the (m, W)-padded compensated pass is affordable for this
    matrix (slot-array bytes and padding blow-up within the caps)."""
    m = a.shape[0]
    w = max(_max_row_nnz(a), 1)
    if m * w * 8 > EXACT_MAX_SLOT_BYTES:
        return False
    return m * w <= EXACT_MAX_PAD_RATIO * max(a.nnz, 1)


def _rowmajor_slots(a):
    """Row-major ELL view (colidx, vals) of shape (m, W), -1 padded —
    cached on the container (the static operand is transformed once)."""
    cache = getattr(a, "_rowmajor_slots", None)
    if cache is not None:
        return cache
    if a.format_name == "csr":
        csr = a
    elif hasattr(a, "to_csr"):
        csr = a.to_csr()
    else:  # e.g. ELL exposes to_coo only
        csr = a.to_coo().to_csr()
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    indices = np.asarray(csr.indices, dtype=np.int32)
    values = np.asarray(csr.values, dtype=np.float32)
    m = csr.shape[0]
    row_len = np.diff(indptr)
    w = max(int(row_len.max()) if m else 0, 1)
    colidx = np.full((m, w), -1, np.int32)
    vals = np.zeros((m, w), np.float32)
    rows = np.repeat(np.arange(m, dtype=np.int64), row_len)
    slots = np.arange(len(indices), dtype=np.int64) - np.repeat(indptr[:-1], row_len)
    colidx[rows, slots] = indices
    vals[rows, slots] = values
    out = (colidx, vals)
    try:
        object.__setattr__(a, "_rowmajor_slots", out)
    except Exception:
        pass
    return out


# Error-free transformations assume every multiply is ROUNDED before its
# result feeds an add/sub.  LLVM's default contraction fuses
# mul-feeding-add into fma inside vectorized loop bodies (XLA:CPU), which
# silently substitutes the EXACT product where the EFT needs the rounded
# one — observed here as the compensated sum losing exactly one product
# residual, and only for vectorized (n>1) shapes.  optimization_barrier
# does NOT protect against this: the CPU pipeline strips all barriers
# before codegen (verified: 22 barriers in the unoptimized HLO, 0 in the
# optimized).  The reliable fix is an OPAQUE runtime 1.0 multiplier on
# every product: ``(a*b)*one`` forces the inner mul's result to be
# materialized (any contraction then fuses with ``one``, which is
# value-preserving), and being a traced argument it cannot be
# constant-folded away.  ``one`` must come from the caller's traced
# inputs.


def _veltkamp_split(x, one):
    """Exact 12+12-bit split of an f32: x == hi + lo with hi*hi products
    representable exactly.  Factor 2^12 + 1 (f32 has a 24-bit mantissa)."""
    c = (jnp.float32(4097.0) * x) * one
    hi = c - (c - x)
    return hi, x - hi


def _two_product(a, b, one):
    """p = fl(a*b) and the EXACT rounding residual e (Dekker)."""
    a_hi, a_lo = _veltkamp_split(a, one)
    b_hi, b_lo = _veltkamp_split(b, one)
    p = (a * b) * one
    # the four sub-products are exact in f32 (12-bit × 12-bit operands),
    # so contraction is harmless in this expression
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def _two_sum(x, y):
    """s = fl(x+y) and the exact residual (Knuth, branch-free).  Adds and
    subs only — nothing for contraction to fuse."""
    s = x + y
    yy = s - x
    err = (x - (s - yy)) + (y - yy)
    return s, err


@jax.jit
def _spmm_compensated(colidx_t, vals_t, b, one):
    """colidx_t/vals_t: (W, m) slot-major row-ELL arrays; ``one`` is a
    runtime f32 scalar equal to 1.0 (opaque contraction blocker).

    NB deliberately lax.scan, NOT a constant-trip-count fori_loop: XLA
    fully unrolls the latter and its CSE then merges optimization_barrier
    subexpressions across iterations, silently destroying the error-free
    transformations (observed on the CPU backend: the TwoSum residual
    came back equal to the Dekker residual).  scan keeps one loop body.
    """
    m = colidx_t.shape[1]
    n = b.shape[1]
    zeros = jnp.zeros((m, n), jnp.float32)

    def body(carry, cv):
        acc, comp = carry
        c_i, a_i = cv
        valid = c_i >= 0
        b_i = jnp.take(b, jnp.where(valid, c_i, 0), axis=0)
        a_col = jnp.where(valid, a_i, 0.0)[:, None]
        p, e = _two_product(a_col, b_i, one)
        acc, r = _two_sum(acc, p)
        return (acc, comp + (r + e)), None

    (acc, comp), _ = jax.lax.scan(body, (zeros, zeros),
                                  (colidx_t, vals_t))
    return acc + comp


def spmm_exact(a, b):
    """C = A @ B with compensated f32 accumulation: deterministic
    rel-1e-2/abs-1e-3 gate pass regardless of value magnitude or
    summation order (the f32 answer to the reference's f64 accumulator,
    reference/src/main.cu:185)."""
    colidx, vals = _rowmajor_slots(a)
    # own attribute name: `_device_arrays` is the tuple-typed cache the
    # plan objects use — sharing it with a dict here would break any code
    # treating that attribute uniformly
    dev = getattr(a, "_exact_cache", None)
    if dev is not None:
        colidx_d, vals_d = dev
    else:
        colidx_d = jnp.asarray(colidx.T)  # slot-major for the scan
        vals_d = jnp.asarray(vals.T)
        if not isinstance(b, jax.core.Tracer):  # tracer-leak guard
            try:
                object.__setattr__(a, "_exact_cache", (colidx_d, vals_d))
            except Exception:
                pass
    b = jnp.asarray(b, dtype=jnp.float32)
    return _spmm_compensated(colidx_d, vals_d, b, jnp.float32(1.0))
