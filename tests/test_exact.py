"""Compensated-accumulation SpMM: the deterministic gate for
extreme-|value| matrices (the reference's f64-accumulator
guarantee, reference/src/main.cu:185).

The corpus's medium_2880 (g7jac010, |values| ~ 1e7) has one output
element on the gate boundary: any plain-f32 strategy passes or misses by
operand luck (medium_2880's "boundary case").  These tests pin the
Dekker/TwoSum path as deterministic."""

import numpy as np
import pytest

from tpuspmm.formats import CSR, COO
from tpuspmm.ops import exact, oracle
from tpuspmm.utils.compare import allclose


def _extreme_cancelling_problem(seed, m=64, k=96, n=32, scale=1e7):
    """Rows whose large-magnitude products cancel to O(1) outputs —
    adversarial for f32 accumulation in any order."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for r in range(m):
        c = rng.choice(k, size=4, replace=False)
        big = np.float32(scale * (1 + rng.random()))
        rows += [r, r, r, r]
        cols += list(c)
        # +big and -big hit DIFFERENT columns of B, so exact cancellation
        # needs b[c0] ≈ b[c1]; we force that below
        vals += [big, -big, np.float32(rng.standard_normal()),
                 np.float32(rng.standard_normal())]
    a = COO(shape=(m, k), rows=np.array(rows, np.int32),
            cols=np.array(cols, np.int32),
            values=np.array(vals, np.float32)).to_csr()
    b = rng.standard_normal((k, n)).astype(np.float32)
    # pair the big +/- columns: make their B rows nearly identical so the
    # products cancel to O(scale * 1e-7) = O(1)
    colidx, valarr = exact._rowmajor_slots(a)
    for r in range(m):
        big_slots = np.where(np.abs(valarr[r]) > 1.0)[0]
        if len(big_slots) == 2:
            c0, c1 = colidx[r, big_slots[0]], colidx[r, big_slots[1]]
            b[c1] = b[c0] * (1 + 1e-7)
    return a, b


def test_two_product_and_two_sum_are_error_free():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(1000).astype(np.float32) * 1e7)
    y = jnp.asarray(rng.standard_normal(1000).astype(np.float32))
    p, e = exact._two_product(x, y, jnp.float32(1.0))
    exact_prod = np.asarray(x, np.float64) * np.asarray(y, np.float64)
    np.testing.assert_allclose(np.asarray(p, np.float64) + np.asarray(e, np.float64),
                               exact_prod, rtol=0, atol=0)
    s, r = exact._two_sum(x, y)
    np.testing.assert_allclose(np.asarray(s, np.float64) + np.asarray(r, np.float64),
                               np.asarray(x, np.float64) + np.asarray(y, np.float64),
                               rtol=0, atol=0)


def test_exact_beats_plain_f32_on_cancellation():
    a, b = _extreme_cancelling_problem(seed=7)
    ref = oracle.spmm_oracle(a, b)  # float64
    out = np.asarray(exact.spmm_exact(a, b))
    assert allclose(out, ref, 1e-2, 1e-3)
    # the same problem through a plain-f32 row sum misses the gate —
    # proves the fixture is adversarial, not that other kernels are wrong
    dense = np.zeros(a.shape, np.float32)
    colidx, vals = exact._rowmajor_slots(a)
    for r in range(a.shape[0]):
        sel = colidx[r] >= 0
        dense[r, colidx[r][sel]] += vals[r][sel]
    plain = dense.astype(np.float32) @ b.astype(np.float32)
    assert not allclose(plain, ref, 1e-2, 1e-3)


@pytest.mark.parametrize("seed", range(8))
def test_exact_gate_deterministic_over_operands(seed):
    a, b = _extreme_cancelling_problem(seed=seed)
    ref = oracle.spmm_oracle(a, b)
    out = np.asarray(exact.spmm_exact(a, b))
    assert allclose(out, ref, 1e-2, 1e-3)


def test_needs_compensated_detection():
    a_small = CSR.random(40, 40, 0.2, seed=1)  # U(-100,100) values
    assert not exact.needs_compensated(a_small)
    a, _ = _extreme_cancelling_problem(seed=3)
    assert exact.needs_compensated(a)


def test_dispatch_routes_extreme_matrices_to_exact():
    from tpuspmm.kernels import dispatch

    a, b = _extreme_cancelling_problem(seed=11)
    ref = oracle.spmm_oracle(a, b)
    out = np.asarray(dispatch.spmm_auto(a, b))
    assert allclose(out, ref, 1e-2, 1e-3)
    np.testing.assert_array_equal(out, np.asarray(exact.spmm_exact(a, b)))


def test_api_method_exact():
    import tpuspmm

    a, b = _extreme_cancelling_problem(seed=5)
    ref = oracle.spmm_oracle(a, b)
    out = np.asarray(tpuspmm.spmm(a, b, method="exact"))
    assert allclose(out, ref, 1e-2, 1e-3)


def test_engine_has_compensated_variant_every_format():
    from tpuspmm.engine.registry import get_engine, FORMATS

    for fmt in FORMATS:
        names = [v.name for v in get_engine(fmt).variants]
        assert "xla_compensated" in names, fmt


def test_medium_2880_corpus_gate_deterministic():
    """The named boundary matrix: the compensated path must pass the gate
    for MANY random operands (the tile-ordered f32 paths miss for some)."""
    import os

    from tpuspmm.data import data_dir
    from tpuspmm.formats import convert

    d = data_dir("medium_2880")
    if d is None or not os.path.isdir(d):
        pytest.skip("medium_2880 corpus dir unavailable")
    a = convert.load_sparse(d, "csr")
    assert exact.needs_compensated(a)
    for seed in range(4):
        rng = np.random.default_rng(seed)
        b = rng.standard_normal((a.shape[1], 64)).astype(np.float32)
        ref = oracle.spmm_scipy_oracle(a, b)
        out = np.asarray(exact.spmm_exact(a, b))
        assert allclose(out, ref, 1e-2, 1e-3), f"seed {seed}"


def test_exact_admissible_blocks_pathological_skew():
    """One heavy row in a large matrix makes the (m, W)-padded compensated
    pass unaffordable — it must be inadmissible, and the auto dispatch
    must fall through to an nnz-proportional strategy instead of
    materializing the O(m*W) slot arrays (review r3)."""
    m, k = 1000, 900
    rows = np.concatenate([np.zeros(800, np.int32),
                           np.arange(1, m, dtype=np.int32)])
    cols = np.concatenate([np.arange(800, dtype=np.int32),
                           np.arange(1, m, dtype=np.int32) % k])
    vals = np.ones(len(rows), np.float32)
    vals[0] = 1.0e5  # extreme value: needs_compensated fires
    a = COO(shape=(m, k), rows=rows, cols=cols, values=vals).to_csr()
    assert exact.needs_compensated(a)
    # pad ratio m*W / nnz = 1000*800 / 1799 ≈ 445 >> cap
    assert not exact.exact_admissible(a)

    from tpuspmm.kernels import dispatch

    rng = np.random.default_rng(3)
    b = rng.standard_normal((k, 32)).astype(np.float32)
    out = np.asarray(dispatch.spmm_auto(a, b))
    ref = oracle.spmm_scipy_oracle(a, b)
    # products here don't cancel, so the plain-f32 fallback stays in-gate
    assert allclose(out, ref, 1e-2, 1e-3)


def test_exact_admissible_accepts_balanced():
    a = CSR.random(512, 512, 0.02, seed=5)
    assert exact.exact_admissible(a)
