"""Vendor-baseline SpMM: cuSPARSE through `jax.experimental.sparse`.

Plays exactly the role cuSPARSE plays in the reference: a library-provided
path that is timed and reported as kernel number -1
(reference/src/engine/cusparse.cu:10-57, reference/src/engine/engine.cpp:47-55).
The reference pairs CSR with `CUSPARSE_SPMM_CSR_ALG2` and COO with
`CUSPARSE_SPMM_COO_ALG4` (reference/src/formats/sparse_csr.cu:182-185,
sparse_coo.cu:97-100); here CSR lowers to BCSR and every other format to
BCOO, and on a GPU both are compiled with ``jax_bcoo_cusparse_lowering``
on, so XLA emits cuSPARSE calls.  The lowering that actually ran is read
from the compiled program and kept for the records (:func:`last_lowering`).
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

from jax.experimental import sparse as jsparse


@contextlib.contextmanager
def _cusparse_lowering():
    prev = jax.config.jax_bcoo_cusparse_lowering
    jax.config.update("jax_bcoo_cusparse_lowering", True)
    try:
        yield
    finally:
        jax.config.update("jax_bcoo_cusparse_lowering", prev)


# Used only under _cusparse_lowering, so its compile cache never holds a
# program lowered without the flag.
_sparse_matmul = jax.jit(lambda a, b: a @ b)


def supports_vendor(fmt: str) -> bool:
    return fmt in ("csr", "coo", "bsr", "ell")


def _vendor_cached(a, key, build):
    cache = getattr(a, "_vendor_cache", None)
    if cache is None:
        cache = {}
        try:
            object.__setattr__(a, "_vendor_cache", cache)
        except Exception:
            return build()
    if key not in cache:
        cache[key] = build()
    return cache[key]


def to_bcoo(a) -> "jsparse.BCOO":
    """Lower any container to BCOO (duplicates summed, indices sorted as
    cuSPARSE requires).  Cached on the container — the lowering is the
    vendor path's prolog, paid once like cuSPARSE descriptor setup
    (reference/src/engine/cusparse.cu:19-31)."""
    from tpuspmm.ops.xla import coo_view

    def build():
        coo = coo_view(a)
        idx = np.stack([np.asarray(coo.rows), np.asarray(coo.cols)],
                       axis=1).astype(np.int32)
        m = jsparse.BCOO((jnp.asarray(np.asarray(coo.values, np.float32)),
                          jnp.asarray(idx)), shape=coo.shape)
        return m.sum_duplicates(nse=m.nse)

    return _vendor_cached(a, "bcoo", build)


def to_bcsr(a) -> "jsparse.BCSR":
    """Lower a CSR container to BCSR — the analogue of the reference pairing
    CSR with `CUSPARSE_SPMM_CSR_ALG2` (reference/src/formats/sparse_csr.cu:182-185)."""
    def build():
        return jsparse.BCSR(
            (jnp.asarray(np.asarray(a.values, np.float32)),
             jnp.asarray(np.asarray(a.indices, np.int32)),
             jnp.asarray(np.asarray(a.indptr, np.int32))),
            shape=a.shape,
        )

    return _vendor_cached(a, "bcsr", build)


def last_lowering(a) -> str:
    """The lowering that served the last spmm_vendor call for this
    container: ``cusparse_bcsr`` / ``cusparse_bcoo`` when the compiled
    program calls cuSPARSE, ``xla_bcsr`` / ``xla_bcoo`` otherwise."""
    return getattr(a, "_vendor_lowering", "")


def _lowering_of(mat, b, kind: str) -> str:
    """Read the compiled program: does it call cuSPARSE?"""
    text = _sparse_matmul.lower(mat, b).compile().as_text() or ""
    lib = "cusparse" if "cusparse" in text.lower() else "xla"
    return f"{lib}_{kind}"


def spmm_vendor(a, b):
    """Vendor-baseline SpMM (the -1 kernel).  CSR → BCSR, everything else
    → BCOO.  B is served in f32 (cuSPARSE takes A and B of one dtype; a
    bf16 B widens exactly); the result is f32."""
    from tpuspmm.formats import CSR

    b = jnp.asarray(b)
    if b.dtype != jnp.float32:
        b = b.astype(jnp.float32)
    kind = "bcsr" if isinstance(a, CSR) else "bcoo"
    mat = to_bcsr(a) if kind == "bcsr" else to_bcoo(a)
    with _cusparse_lowering():
        if not isinstance(b, jax.core.Tracer):
            lowering = _vendor_cached(
                a, ("lowering", kind, b.shape),
                lambda: _lowering_of(mat, b, kind))
            object.__setattr__(a, "_vendor_lowering", lowering)
        return _sparse_matmul(mat, b)
