"""Differential tests: every kernel variant vs the numpy oracle at the
reference tolerances (rel 1e-2 / abs 1e-3, reference/include/utils.hpp:10-11)
— tier-1 of the reference's strategy, run per variant like runEngine's loop
(reference/src/engine/engine.cpp:41-43).
"""

import numpy as np
import pytest
import scipy.sparse

from tpuspmm.config import Config
from tpuspmm.formats import CSR, COO, convert
from tpuspmm.engine.registry import get_engine, FORMATS
from tpuspmm.ops import oracle
from tpuspmm.utils.compare import allclose

CFG = Config(interpret=True)


def _rand(m, k, density, seed=0):
    rng = np.random.default_rng(seed)
    return scipy.sparse.random(
        m, k, density=density, format="csr", random_state=rng,
        data_rvs=lambda n: rng.uniform(-100, 100, n),
    )


CASES = [
    # (m, k, n, density) — spanning tile-aligned and ragged shapes
    (32, 32, 32, 0.1),
    (100, 130, 48, 0.05),
    (256, 256, 128, 0.02),
    (300, 511, 96, 0.15),
]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}x{c[2]}d{c[3]}")
def test_all_variants_match_oracle(fmt, case):
    m, k, n, density = case
    sp = _rand(m, k, density, seed=m + k)
    a = convert.to_format(sp, fmt)
    rng = np.random.default_rng(m)
    b = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    ref = oracle.spmm_oracle(a, b)

    engine = get_engine(fmt)
    for variant in engine.variants:
        if variant.inadmissible_reason(a, b, CFG):
            continue
        out = np.asarray(variant.fn(a, b, CFG))
        assert allclose(out, ref, CFG.rel_tol, CFG.abs_tol), (
            f"{fmt} kernel {variant.number} ({variant.name}) mismatch: "
            f"maxerr={np.abs(out - ref).max()}"
        )


@pytest.mark.parametrize("fmt", FORMATS)
def test_vendor_matches_oracle(fmt):
    sp = _rand(90, 120, 0.07, seed=5)
    a = convert.to_format(sp, fmt)
    rng = np.random.default_rng(2)
    b = rng.uniform(-1, 1, (120, 40)).astype(np.float32)
    ref = oracle.spmm_oracle(a, b)
    from tpuspmm.ops import vendor

    out = np.asarray(vendor.spmm_vendor(a, b))
    assert allclose(out, ref, CFG.rel_tol, CFG.abs_tol)


def test_coo_duplicates_through_kernels():
    """Duplicate coordinates accumulate through every COO path."""
    a = COO(
        rows=np.array([0, 0, 3], dtype=np.int32),
        cols=np.array([2, 2, 1], dtype=np.int32),
        values=np.array([1.5, 2.5, -1.0], dtype=np.float32),
        shape=(8, 8),
    ).sort_by_row()
    b = np.eye(8, dtype=np.float32)
    ref = oracle.spmm_coo_oracle(a, b)
    assert ref[0, 2] == 4.0
    engine = get_engine("coo")
    for variant in engine.variants:
        out = np.asarray(variant.fn(a, b, CFG))
        assert allclose(out, ref, CFG.rel_tol, CFG.abs_tol), variant.name


def test_spmv_and_transpose():
    from tpuspmm.ops.api import spmv, spmm_transpose

    sp = _rand(60, 80, 0.1, seed=21)
    a = CSR.from_scipy(sp)
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, 80).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(spmv(a, x, method="xla")), sp.toarray() @ x, rtol=1e-4, atol=1e-4
    )
    g = rng.uniform(-1, 1, (60, 16)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(spmm_transpose(a, g, method="xla")), sp.toarray().T @ g,
        rtol=1e-3, atol=1e-3,
    )


def test_spmm_batched_folds_batch_into_lanes():
    from tpuspmm.ops.api import spmm_batched

    sp = _rand(60, 80, 0.1, seed=22)
    a = CSR.from_scipy(sp)
    rng = np.random.default_rng(7)
    dense = sp.toarray()
    # 3-D batch and a 2-level (2, 3) batch; each element must equal the
    # per-element product (the fold must not mix batch elements)
    for shape in [(4, 80, 16), (2, 3, 80, 16)]:
        b = rng.uniform(-1, 1, shape).astype(np.float32)
        out = np.asarray(spmm_batched(a, b, method="xla"))
        assert out.shape == shape[:-2] + (60, 16)
        ref = np.einsum("mk,...kn->...mn", dense, b)
        np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)
    # 2-D input degrades to plain spmm
    b2 = rng.uniform(-1, 1, (80, 16)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(spmm_batched(a, b2, method="xla")),
                               dense @ b2, rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError):
        spmm_batched(a, rng.uniform(-1, 1, (4, 81, 16)).astype(np.float32))


class TestEdgeCases:
    def test_empty_matrix_all_paths(self):
        """nnz=0 must produce all-zeros through every strategy."""
        from tpuspmm.kernels import blocksparse_gpu, dispatch
        from tpuspmm.ops import xla

        a = CSR.from_scipy(scipy.sparse.csr_matrix((40, 60), dtype=np.float32))
        b = np.ones((60, 16), np.float32)
        for out in (
            dispatch.spmm_auto(a, b, CFG),
            blocksparse_gpu.spmm_blocksparse(a, b, interpret=True),
            xla.spmm_csr_xla(a, b),
        ):
            out = np.asarray(out)
            assert out.shape == (40, 16)
            assert np.all(out == 0.0)

    def test_single_nnz(self):
        from tpuspmm.kernels import blocksparse_gpu

        a = COO(rows=np.array([3], np.int32), cols=np.array([140], np.int32),
                values=np.array([2.0], np.float32), shape=(10, 200))
        b = np.arange(200 * 8, dtype=np.float32).reshape(200, 8)
        expect = np.zeros((10, 8), np.float32)
        expect[3] = 2.0 * b[140]
        for out in (blocksparse_gpu.spmm_blocksparse(a, b, interpret=True),
                    get_engine("coo").variant(1).fn(a, b, CFG)):
            np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-6)


@pytest.mark.parametrize("fmt", FORMATS)
def test_pallas_variant_refuses_to_run_uninterpreted_on_cpu(fmt):
    """Called directly on the CPU without interpret mode, the Triton
    kernel raises instead of silently running interpreted."""
    from tpuspmm.config import Config

    a = convert.to_format(_rand(30, 40, 0.1, seed=3), fmt)
    b = np.ones((40, 8), np.float32)
    v = next(v for v in get_engine(fmt).variants if v.requires_gpu)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        v.fn(a, b, Config(interpret=False))


@pytest.mark.parametrize("method", ["xla", "pallas", "densify", "exact",
                                    "auto"])
def test_public_methods_match_oracle(method):
    """Every public spmm method serves the same product."""
    import tpuspmm

    sp = _rand(70, 90, 0.08, seed=31)
    a = CSR.from_scipy(sp)
    b = np.random.default_rng(8).uniform(-1, 1, (90, 24)).astype(np.float32)
    out = np.asarray(tpuspmm.spmm(a, b, method=method))
    assert allclose(out, sp.toarray() @ b, CFG.rel_tol, CFG.abs_tol)
