"""Format containers: loaders, converters, dense round-trips.

Covers the reference's L2 format layer behaviours
(reference/src/formats/*.cu) including the bundled small fixtures.
"""

import os

import numpy as np
import pytest
import scipy.sparse

from tpuspmm.formats import CSR, COO, BSR, ELL, DenseMatrix, convert
from tpuspmm.formats import io as fio


def random_scipy(rng, m=64, k=96, density=0.1):
    return scipy.sparse.random(
        m, k, density=density, format="csr",
        random_state=np.random.default_rng(7),
        data_rvs=lambda n: np.random.default_rng(8).uniform(-100, 100, n),
    )


# --------------------------------------------------------------------------
# reference text-file loaders (fixtures shipped with the reference)
# --------------------------------------------------------------------------

def test_load_reference_csr(small32_dir):
    a = CSR.from_file(os.path.join(small32_dir, "Hamrle1.csr"))
    assert a.shape == (32, 32)
    assert a.nnz == 98
    assert a.indptr[0] == 0 and a.indptr[-1] == 98


def test_load_reference_coo_matches_csr(small32_dir):
    a = CSR.from_file(os.path.join(small32_dir, "Hamrle1.csr"))
    c = COO.from_file(os.path.join(small32_dir, "Hamrle1.coo"))
    assert c.nnz == a.nnz
    np.testing.assert_allclose(c.to_dense(), a.to_dense(), rtol=1e-6)


def test_load_reference_mtx_matches_csr(small32_dir):
    a = CSR.from_file(os.path.join(small32_dir, "Hamrle1.csr"))
    m = fio.read_mtx(os.path.join(small32_dir, "Hamrle1.mtx"))
    np.testing.assert_allclose(
        np.asarray(m.todense(), dtype=np.float32), a.to_dense(), rtol=1e-6
    )


def test_load_reference_dense(small32_dir):
    d = DenseMatrix.from_file(os.path.join(small32_dir, "dense.in"))
    assert d.shape == (32, 32)
    m = fio.read_mtx(os.path.join(small32_dir, "dense.mtx"))
    import scipy.sparse as sp

    arr = m.toarray() if sp.issparse(m) else np.asarray(m)
    np.testing.assert_allclose(d.data, arr.astype(np.float32), rtol=1e-6)


# --------------------------------------------------------------------------
# round-trips: save → load → identical
# --------------------------------------------------------------------------

def test_csr_text_roundtrip(tmp_path, rng):
    a = CSR.from_scipy(random_scipy(rng))
    p = str(tmp_path / "m.csr")
    a.save(p)
    b = CSR.from_file(p)
    assert b.shape == a.shape
    np.testing.assert_array_equal(b.indptr, a.indptr)
    np.testing.assert_array_equal(b.indices, a.indices)
    np.testing.assert_allclose(b.values, a.values, rtol=1e-6)


def test_coo_text_roundtrip(tmp_path, rng):
    a = COO.from_scipy(random_scipy(rng))
    p = str(tmp_path / "m.coo")
    a.save(p)
    b = COO.from_file(p)
    np.testing.assert_allclose(b.to_dense(), a.to_dense(), rtol=1e-6)


def test_bsr_text_roundtrip(tmp_path, rng):
    a = BSR.from_scipy(random_scipy(rng, 64, 96), block_size=(4, 4))
    p = str(tmp_path / "m.bsr")
    a.save(p)
    b = BSR.from_file(p)
    assert b.block_size == (4, 4)
    np.testing.assert_allclose(b.to_dense(), a.to_dense(), rtol=1e-6)


def test_ell_text_roundtrip(tmp_path, rng):
    a = ELL.from_scipy(random_scipy(rng))
    rp, vp = str(tmp_path / "m_rowind.ell"), str(tmp_path / "m_values_colmajor.ell")
    a.save(rp, vp)
    b = ELL.from_file(rp, vp)
    assert b.max_col_nnz == a.max_col_nnz
    np.testing.assert_allclose(b.to_dense(), a.to_dense(), rtol=1e-6)


def test_dense_text_roundtrip(tmp_path, rng):
    arr = rng.standard_normal((17, 23)).astype(np.float32)
    d = DenseMatrix.from_array(arr)
    p = str(tmp_path / "dense.in")
    d.save(p)
    e = DenseMatrix.from_file(p)
    np.testing.assert_allclose(e.data, arr, rtol=1e-6)


# --------------------------------------------------------------------------
# cross-format conversions agree on to_dense
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["csr", "coo", "bsr", "ell"])
def test_format_dense_roundtrip(fmt, rng):
    sp = random_scipy(rng, 64, 64, 0.15)
    dense = np.asarray(sp.todense(), dtype=np.float32)
    a = convert.to_format(sp, fmt)
    np.testing.assert_allclose(a.to_dense(), dense, rtol=1e-5, atol=1e-6)
    # from_dense too
    cls = type(a)
    if fmt != "bsr":
        b = cls.from_dense(dense)
    else:
        b = cls.from_dense(dense, block_size=(4, 4))
    np.testing.assert_allclose(b.to_dense(), dense, rtol=1e-5, atol=1e-6)


def test_coo_duplicate_accumulation():
    """COO semantics: duplicate coordinates accumulate
    (reference/src/spmm/coo/spmm_coo_k1.cu:24 atomicAdd)."""
    a = COO(
        rows=np.array([0, 0, 1], dtype=np.int32),
        cols=np.array([1, 1, 0], dtype=np.int32),
        values=np.array([2.0, 3.0, 4.0], dtype=np.float32),
        shape=(2, 2),
    )
    expected = np.array([[0, 5], [4, 0]], dtype=np.float32)
    np.testing.assert_allclose(a.to_dense(), expected)


def test_bsr_real_blocks(rng):
    """Real block tiling — beyond the reference's degenerate 1×1 data
    (reference/utils/python_utils/convert_mtx.py:22)."""
    a = BSR.random_blocks(64, 256, (8, 128), 0.5, seed=3)
    assert a.block_size == (8, 128)
    d = a.to_dense()
    assert d.shape == (64, 256)
    b = BSR.from_dense(d, block_size=(8, 128))
    np.testing.assert_allclose(b.to_dense(), d, rtol=1e-6)


def test_pytree_device_roundtrip(rng):
    import jax

    a = CSR.from_scipy(random_scipy(rng))
    dev = a.to_device()
    assert dev.on_device
    leaves = jax.tree_util.tree_leaves(dev)
    assert all(isinstance(l, jax.Array) for l in leaves)
    back = dev.to_host()
    np.testing.assert_allclose(back.values, a.values)


def test_discover_and_load(small32_dir):
    found = convert.discover(small32_dir)
    assert found["csr"] and found["coo"] and found["dense"]
    a = convert.load_sparse(small32_dir, "csr")
    assert a.shape == (32, 32)
    # bsr/ell fall back to .mtx conversion
    bsr = convert.load_sparse(small32_dir, "bsr")
    np.testing.assert_allclose(bsr.to_dense(), a.to_dense(), rtol=1e-5, atol=1e-6)
    ell = convert.load_sparse(small32_dir, "ell")
    np.testing.assert_allclose(ell.to_dense(), a.to_dense(), rtol=1e-5, atol=1e-6)


class TestCSC:
    """CSC container (the reference ships .csc files its binary ignores)."""

    def test_reference_csc_matches_csr(self, small10_dir):
        import os
        from tpuspmm.formats import CSC, CSR

        csc = CSC.from_file(os.path.join(small10_dir, "sparse.csc"))
        csr = CSR.from_file(os.path.join(small10_dir, "sparse.csr"))
        assert csc.shape == csr.shape and csc.nnz == csr.nnz
        np.testing.assert_allclose(csc.to_dense(), csr.to_dense(), rtol=1e-6)

    def test_round_trip(self, tmp_path):
        from tpuspmm.formats import CSC

        rng = np.random.default_rng(0)
        dense = (rng.random((12, 18)) < 0.3) * rng.standard_normal((12, 18))
        a = CSC.from_dense(dense.astype(np.float32))
        p = str(tmp_path / "m.csc")
        a.save(p)
        back = CSC.from_file(p)
        np.testing.assert_allclose(back.to_dense(), a.to_dense(), rtol=1e-6)

    def test_spmm_via_conversion(self):
        import tpuspmm
        from tpuspmm.formats import CSC
        from tpuspmm.ops import oracle

        a_csr = tpuspmm.CSR.random(50, 70, 0.1, seed=1)
        a = CSC.from_scipy(a_csr.to_scipy())
        b = np.random.default_rng(0).standard_normal((70, 8)).astype(np.float32)
        out = np.asarray(tpuspmm.spmm(a.to_csr(), b, method="xla"))
        from tpuspmm.utils.compare import allclose
        assert allclose(out, oracle.spmm_oracle(a_csr, b), 1e-2, 1e-3)

    def test_csc_direct_spmm_paths(self):
        """CSC must work through spmm/dispatch without manual conversion."""
        import tpuspmm
        from tpuspmm.formats import CSC
        from tpuspmm.kernels import dispatch
        from tpuspmm.ops import oracle
        from tpuspmm.utils.compare import allclose

        a_csr = tpuspmm.CSR.random(60, 90, 0.1, seed=2)
        a = CSC.from_scipy(a_csr.to_scipy())
        b = np.random.default_rng(1).standard_normal((90, 16)).astype(np.float32)
        ref = oracle.spmm_oracle(a_csr, b)
        assert allclose(np.asarray(tpuspmm.spmm(a, b, method="xla")), ref, 1e-2, 1e-3)
        assert allclose(np.asarray(dispatch.spmm_auto(a, b)), ref, 1e-2, 1e-3)
