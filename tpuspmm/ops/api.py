"""Public compute API: spmm / spmv / spmm_transpose.

The reference exposes compute only through its engine dispatch
(reference/include/engine/engine_base.hpp:5-10); here a direct functional API
is provided as well, with method selection:

- "oracle" — numpy float64 oracle (kernel 0 semantics)
- "xla"    — gather + segment-sum / batched-matmul XLA paths
- "vendor" — cuSPARSE through jax.experimental.sparse (kernel -1 semantics)
- "pallas" — the block-sparse Pallas/Triton kernel (GPU, or interpreted
  when the config asks for it)
- "exact"  — compensated f32 accumulation (ops/exact.py): deterministic
  rel-1e-2/abs-1e-3 gate regardless of value magnitude (the reference's
  f64-accumulator guarantee, reference/src/main.cu:185)
- "densify" — densify once (cached), one dense cuBLAS matmul per call
- "tuned"  — verified autotune: measure every admissible variant once,
  serve the winner
- "auto"   — the route ``kernels.dispatch.choose_route`` picks, the same
  dispatcher on every backend
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def spmm(a, b, method: str = "auto"):
    """Sparse @ dense.  `a` is a tpuspmm container, `b` a (K, N) array."""
    from tpuspmm.kernels import dispatch
    from tpuspmm.ops import oracle, xla, vendor

    if method == "auto":
        return dispatch.spmm_auto(a, b)
    if method == "oracle":
        return oracle.spmm_oracle(a, np.asarray(b))
    if method == "vendor":
        return vendor.spmm_vendor(a, b)
    if method == "xla":
        return dispatch.spmm_xla_any(a, b)
    if method == "pallas":
        from tpuspmm.config import default_config
        from tpuspmm.kernels import blocksparse_gpu

        return blocksparse_gpu.spmm_blocksparse(
            a, b, interpret=default_config().interpret)
    if method == "tuned":
        from tpuspmm.engine.autotune import spmm_tuned

        return spmm_tuned(a, b)
    if method == "exact":
        from tpuspmm.ops import exact

        return exact.spmm_exact(a, b)
    if method == "densify":
        return xla.spmm_densify_cached(a, b)
    raise ValueError(f"unknown method {method!r}")


def spmv(a, x, method: str = "auto"):
    """Sparse @ vector — SpMM with N=1 (the capability the reference's
    SpMM generalizes; kept as a first-class entry point)."""
    x = jnp.asarray(x)
    squeeze = x.ndim == 1
    b = x[:, None] if squeeze else x
    out = spmm(a, b, method=method)
    return out[:, 0] if squeeze else out


def spmm_batched(a, b, method: str = "auto"):
    """One sparse operand against a STACK of dense operands:
    ``b`` is (..., K, N) with any leading batch dims; returns (..., M, N).

    The batch is folded into the column dimension —
    (..., K, N) → (K, prod(batch)·N) → one wide SpMM → un-fold — so a
    single launch serves the whole batch and the plan reads amortize
    across every batch element instead of being re-paid per element.
    The fold/unfold are XLA transposes/reshapes that fuse into the
    surrounding program.  (The reference has no batched entry; serving
    stacks like multi-head projections against one pruned weight matrix
    need it.)"""
    b = jnp.asarray(b)
    if b.ndim == 2:
        return spmm(a, b, method=method)
    if b.ndim < 2 or b.shape[-2] != a.shape[1]:
        raise ValueError(f"b must be (..., K={a.shape[1]}, N); got {b.shape}")
    batch = b.shape[:-2]
    k, n = b.shape[-2:]
    # (..., K, N) -> (K, ..., N) -> (K, B*N)
    flat = jnp.moveaxis(b.reshape(-1, k, n), 0, 1).reshape(k, -1)
    out = spmm(a, flat, method=method)  # (M, B*N)
    m = out.shape[0]
    out = jnp.moveaxis(out.reshape(m, -1, n), 1, 0)
    return out.reshape(*batch, m, n)


def spmm_fn(a, method: str = "auto"):
    """Return a differentiable ``b -> A @ b`` closure over the sparse
    operand.

    The backward pass is the transpose SpMM (d/dB of A@B is Aᵀ@dC), run
    through the same machinery — the gradient path a pruned-LLM training
    step needs (frozen sparse weights, trainable dense operand).
    The reference is forward-only (no autograd anywhere); this is
    new-build capability, exercised distributed by
    tpuspmm/parallel/train.py.
    """
    import jax

    @jax.custom_vjp
    def f(b):
        return spmm(a, b, method=method)

    def fwd(b):
        return f(b), None

    def bwd(_, g):
        return (spmm_transpose(a, g, method=method),)

    f.defvjp(fwd, bwd)
    return f


def spmm_transpose(a, b, method: str = "auto"):
    """A^T @ B — needed for gradients w.r.t. the dense operand
    (d/dB of A@B is A^T @ dC).  Implemented by transposing the triplet
    stream; not present in the reference (forward-only harness).

    The transposed container is cached on `a`, and every per-kernel
    artifact (block plan, device triplets, vendor lowering, tune ranking)
    caches on *it* in turn — so the backward runs through the same
    machinery as the forward, paying the transpose preprocessing once per
    matrix."""
    from tpuspmm.formats import COO

    at = getattr(a, "_transposed", None)
    if at is None:
        coo = a if isinstance(a, COO) else (a.to_coo() if hasattr(a, "to_coo") else a.to_csr().to_coo())
        at = COO(rows=np.asarray(coo.cols), cols=np.asarray(coo.rows),
                 values=np.asarray(coo.values), shape=(coo.shape[1], coo.shape[0])).sort_by_row()
        try:
            object.__setattr__(a, "_transposed", at)
        except Exception:
            pass
    return spmm(at, b, method=method)
