"""Native C++ fast-parse layer tests.

The native library is the counterpart of the reference's mmio C reader and
C++ text loaders (SURVEY.md §2.1 N19, N5-N9); every result must agree with
the pure-numpy/scipy fallback bit-for-bit.
"""

import os
import shutil

import numpy as np
import pytest
import scipy.io
import scipy.sparse

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

from tpuspmm.native import fastio

from tpuspmm.data import data_dir


@pytest.fixture(scope="module", autouse=True)
def _built():
    if not fastio.available():
        pytest.skip("native build unavailable")


def test_parse_tokens_matches_numpy(tmp_path):
    p = tmp_path / "body.txt"
    p.write_text("header line to skip\n1 2 3\n4.5 -6e3\n7\n")
    got = fastio.parse_tokens(str(p), 1)
    np.testing.assert_array_equal(got, [1, 2, 3, 4.5, -6e3, 7])


def test_parse_tokens_skip_zero(tmp_path):
    p = tmp_path / "b.txt"
    p.write_text("1.25 -2.5\n3.75\n")
    np.testing.assert_array_equal(fastio.parse_tokens(str(p), 0), [1.25, -2.5, 3.75])


def test_mtx_general(tmp_path):
    rng = np.random.default_rng(0)
    sp = scipy.sparse.random(30, 40, density=0.2, format="coo", random_state=rng)
    path = str(tmp_path / "m.mtx")
    scipy.io.mmwrite(path, sp)
    shape, r, c, v = fastio.read_mtx_triplets(path)
    assert shape == (30, 40)
    got = scipy.sparse.coo_matrix((v, (r, c)), shape=shape).toarray()
    np.testing.assert_allclose(got, sp.toarray(), rtol=1e-12)


def test_mtx_symmetric(tmp_path):
    rng = np.random.default_rng(1)
    a = scipy.sparse.random(20, 20, density=0.2, format="coo", random_state=rng)
    sym = (a + a.T).tocoo()
    path = str(tmp_path / "s.mtx")
    scipy.io.mmwrite(path, sym, symmetry="symmetric")
    shape, r, c, v = fastio.read_mtx_triplets(path)
    got = scipy.sparse.coo_matrix((v, (r, c)), shape=shape).toarray()
    np.testing.assert_allclose(got, sym.toarray(), rtol=1e-10)


def test_mtx_pattern(tmp_path):
    path = str(tmp_path / "p.mtx")
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern general\n")
        f.write("% comment\n3 4 2\n1 1\n3 4\n")
    shape, r, c, v = fastio.read_mtx_triplets(path)
    assert shape == (3, 4)
    np.testing.assert_array_equal(r, [0, 2])
    np.testing.assert_array_equal(c, [0, 3])
    np.testing.assert_array_equal(v, [1.0, 1.0])


def test_mtx_reference_files_match_scipy():
    """Every bundled sparse .mtx parses identically via native and scipy."""
    checked = 0
    for dirname in ("small_32x32", "medium_1484", "large_25605"):
        d = data_dir(dirname)
        if d is None:
            continue
        for name in os.listdir(d):
            if not name.endswith(".mtx") or name == "dense.mtx":
                continue
            path = os.path.join(d, name)
            ref = scipy.sparse.coo_matrix(scipy.io.mmread(path))
            try:
                shape, r, c, v = fastio.read_mtx_triplets(path)
            except fastio.NativeUnavailable:
                continue  # dense or skew — scipy fallback covers it
            got = scipy.sparse.coo_matrix((v, (r, c)), shape=shape)
            assert shape == ref.shape
            np.testing.assert_allclose(got.toarray(), ref.toarray(), rtol=1e-12)
            checked += 1
    if not checked:
        pytest.skip("no reference .mtx available")


def test_io_loaders_use_native_consistently(tmp_path):
    """read_csr_text through the native tokenizer == through numpy."""
    from tpuspmm.formats import CSR
    from tpuspmm.formats import io as fio

    a = CSR.random(50, 60, 0.1, seed=3)
    p = str(tmp_path / "a.csr")
    a.save(p)
    shape, indptr, indices, values = fio.read_csr_text(p)
    assert shape == (50, 60)
    np.testing.assert_array_equal(indptr, np.asarray(a.indptr))
    np.testing.assert_array_equal(indices, np.asarray(a.indices))
    np.testing.assert_allclose(values, np.asarray(a.values), rtol=1e-6)


def test_native_tileplan_matches_numpy():
    """The C++ tile-plan builder must reproduce the numpy plan arrays
    bit-for-bit (same grouping, chunking, ordering, padding)."""
    import scipy.sparse

    from tpuspmm.formats import tiles
    from tpuspmm.native import tileplan as native_tp

    if not native_tp.available():
        import pytest

        pytest.skip("native toolchain unavailable")

    rng = np.random.default_rng(31)
    for (m, k, density, tm, tk, E) in [
        (300, 511, 0.05, 128, 128, 128),
        (1000, 2000, 0.01, 128, 256, 128),
        (64, 64, 0.2, 128, 128, 128),
        (513, 129, 0.0, 128, 128, 128),   # empty matrix
        (900, 100, 0.003, 64, 128, 64),   # rows with empty tiles
    ]:
        sp = scipy.sparse.random(m, k, density=density, format="coo",
                                 random_state=rng,
                                 data_rvs=lambda n: rng.uniform(-5, 5, n))
        ref = tiles.build_tile_plan(sp.row, sp.col, sp.data, (m, k),
                                    tile_m=tm, tile_k=tk, chunk=E)
        got = native_tp.build_tile_plan_arrays(sp.row, sp.col, sp.data,
                                               (m, k), tm, tk, E)
        for name, a, b in zip(("rt", "kt", "first", "rows", "cols", "vals"),
                              got, (ref.rt, ref.kt, ref.first,
                                    ref.rows, ref.cols, ref.vals)):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {m}x{k}")
