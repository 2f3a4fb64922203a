"""The block-sparse Triton kernel (tpuspmm/kernels/blocksparse_gpu.py),
interpreted on the CPU: its plan and the plan's stats, the kernel against
the float64 oracle and against XLA's plain version of the same plan
(bench/kernel_compare.py), and the plan-size cap of the routes that
choose it."""

import ml_dtypes
import numpy as np
import pytest
import scipy.sparse

from bench.kernel_compare import plan_of, spmm_blockplan_xla
from tpuspmm.formats import BSR, COO, CSR, convert
from tpuspmm.kernels import blocksparse_gpu as bs
from tpuspmm.ops import oracle
from tpuspmm.utils.compare import allclose


def _rand(m, k, density, seed):
    rng = np.random.default_rng(seed)
    return scipy.sparse.random(m, k, density=density, format="csr",
                               random_state=rng,
                               data_rvs=lambda n: rng.uniform(-10, 10, n))


def _b(k, n, dtype, seed=0):
    b = np.random.default_rng(seed).uniform(-1, 1, (k, n)).astype(np.float32)
    return b.astype(ml_dtypes.bfloat16) if dtype == "bf16" else b


def _ref(a, b):
    return oracle.spmm_scipy_oracle(a, np.asarray(b).astype(np.float64))


@pytest.mark.parametrize("width", [1, 7, 128, 300])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["csr", "coo", "bsr", "ell"])
def test_kernel_matches_oracle(fmt, dtype, width):
    """Every format × B dtype × width, M and K not tile multiples, with
    empty rows and columns."""
    sp = _rand(90, 150, 0.04, seed=width)
    sp = sp.tolil()
    sp[10:30, :] = 0   # empty rows
    sp[:, 40:70] = 0   # empty columns
    a = convert.to_format(sp.tocsr(), fmt)
    b = _b(150, width, dtype, seed=width)
    out = np.asarray(bs.spmm_blocksparse(plan_of(a, 16, 32), b,
                                         interpret=True))
    assert out.shape == (90, width)
    assert allclose(out, _ref(a, b), 1e-2, 1e-3)
    assert np.all(out[10:30] == 0)


@pytest.mark.parametrize("case", ["duplicates", "empty", "one_nnz",
                                  "long_run", "bf16_tiles", "tall_skinny"])
def test_kernel_edge_cases(case):
    if case == "duplicates":  # duplicates accumulate (COO semantics)
        a = COO(rows=np.array([0, 0, 5, 5, 5], np.int32),
                cols=np.array([3, 3, 1, 1, 40], np.int32),
                values=np.array([1.5, 2.5, 1.0, -4.0, 2.0], np.float32),
                shape=(20, 50))
    elif case == "empty":
        a = CSR.from_scipy(scipy.sparse.csr_matrix((33, 47), dtype=np.float32))
    elif case == "one_nnz":
        a = COO(rows=np.array([32], np.int32), cols=np.array([63], np.int32),
                values=np.array([3.0], np.float32), shape=(33, 64))
    elif case == "long_run":  # one row block with a long run of tiles
        d = np.zeros((40, 700), np.float32)
        d[:16] = np.random.default_rng(1).uniform(-1, 1, (16, 700))
        d[30, 5] = 1.0
        a = CSR.from_dense(d)
    elif case == "bf16_tiles":  # ±1 values: lossless bf16 tiles
        sp = _rand(64, 96, 0.1, seed=2)
        sp.data = np.sign(sp.data).astype(np.float32)
        a = CSR.from_scipy(sp)
    else:
        a = CSR.from_scipy(_rand(500, 20, 0.2, seed=4))
    b = _b(a.shape[1], 24, "f32", seed=3)
    plan = bs.build_block_plan(np.asarray(convert.to_format(a, "coo").rows),
                               np.asarray(convert.to_format(a, "coo").cols),
                               np.asarray(convert.to_format(a, "coo").values),
                               a.shape, bm=16, bk=16)
    out = np.asarray(bs.spmm_blocksparse(plan, b, interpret=True))
    assert allclose(out, _ref(a, b), 1e-2, 1e-3)
    if case == "long_run":
        assert np.max(np.diff(plan.row_ptr)) == -(-700 // 16)
    if case == "bf16_tiles":
        assert plan.tiles.dtype == ml_dtypes.bfloat16


@pytest.mark.parametrize("bm,bk", [(16, 16), (32, 64), (64, 64)])
def test_plan_reproduces_matrix(bm, bk):
    """Plan invariants: tiles sorted by row block, row_ptr delimits each
    block's run, and scattering the tiles back gives the dense matrix."""
    sp = _rand(130, 210, 0.05, seed=bm + bk)
    coo = sp.tocoo()
    plan = bs.build_block_plan(coo.row, coo.col, coo.data, sp.shape, bm, bk)
    assert np.all(np.diff(plan.row_ptr) >= 0)
    assert plan.row_ptr[0] == 0 and plan.row_ptr[-1] == plan.n_tiles
    assert plan.n_row_blocks == -(-130 // bm)
    for i in range(plan.n_row_blocks):
        assert np.all(plan.rb[plan.row_ptr[i]:plan.row_ptr[i + 1]] == i)
    dense = np.zeros((plan.n_row_blocks * bm, -(-210 // bk) * bk))
    tiles = plan.tiles.reshape(-1, bm, bk)
    for t in range(plan.n_tiles):
        r0, c0 = plan.rb[t] * bm, plan.kt[t] * bk
        dense[r0:r0 + bm, c0:c0 + bk] += tiles[t]
    np.testing.assert_allclose(dense[:130, :210], sp.toarray(), rtol=1e-6)
    assert plan.nnz == sp.nnz and 0 < plan.fill <= 1


@pytest.mark.parametrize("vals,cols,want", [
    ([1.0, -1.0, 0.5], [0, 1, 2], ml_dtypes.bfloat16),
    ([1.0, 0.1], [0, 1], np.float32),
    ([256.0, 1.0], [0, 0], np.float32),  # each exact in bf16, the sum not
])
def test_plan_stores_bf16_only_when_lossless(vals, cols, want):
    """Tiles are bf16 exactly when every (duplicate-summed) value
    round-trips bf16."""
    plan = bs.build_block_plan(np.zeros(len(vals), np.int64),
                               np.asarray(cols), np.asarray(vals, np.float32),
                               (4, 4), 16, 16)
    assert plan.tiles.dtype == np.dtype(want)


def test_plan_cached_on_container():
    a = CSR.from_scipy(_rand(50, 60, 0.1, seed=5))
    assert bs.block_plan(a) is bs.block_plan(a)
    assert bs.plan_stats(a) is bs.plan_stats(a)
    assert (bs.block_plan(a).bm, bs.block_plan(a).bk) == (bs.BM, bs.BK)


def test_device_arrays_survive_tracing():
    """A plan first used under a trace must not cache tracers."""
    import jax

    a = CSR.from_scipy(_rand(40, 50, 0.1, seed=6))
    plan = plan_of(a, 16, 16)
    b = _b(50, 8, "f32")
    jax.jit(lambda bb: spmm_blockplan_xla(plan, bb))(b)
    out = np.asarray(bs.spmm_blocksparse(plan, b, interpret=True))
    assert allclose(out, _ref(a, b), 1e-2, 1e-3)


@pytest.mark.parametrize("precision", ["highest", "x3", "x6"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bm,bk", [(16, 16), (64, 64)])
def test_plain_xla_version_matches_kernel(bm, bk, dtype, precision):
    """XLA's plain version of the same plan (the kernel's reference), at
    each dot precision the comparison times, agrees with the oracle and
    with the kernel."""
    import jax

    from bench.kernel_compare import _precision

    a = CSR.from_scipy(_rand(100, 180, 0.05, seed=bm))
    b = _b(180, 40, dtype)
    plan = plan_of(a, bm, bk)
    ref = _ref(a, b)
    route = "xla_blockplan" + ("" if precision == "highest" else
                               "_" + precision)
    plain = np.asarray(spmm_blockplan_xla(plan, b, _precision(route)))
    kern = np.asarray(bs.spmm_blocksparse(plan, b, interpret=True))
    assert allclose(plain, ref, 1e-2, 1e-3)
    assert allclose(kern, plain, 1e-2, 1e-3)
    assert isinstance(_precision(route), (jax.lax.Precision,
                                          jax.lax.DotAlgorithmPreset))


@pytest.mark.parametrize("n,want", [(1, 16), (7, 16), (100, 128), (300, 128)])
def test_pick_bn(n, want):
    assert bs.pick_bn(n) == want


def test_split_dot_ladder_is_f32_accurate():
    """The bf16 split ladder reproduces f32 products to ~2^-24."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 32)).astype(np.float32)
    y = rng.standard_normal((32, 32)).astype(np.float32)
    got = np.asarray(bs._split_dot(jnp.asarray(x), jnp.asarray(y)))
    want = x.astype(np.float64) @ y.astype(np.float64)
    assert np.max(np.abs(got - want)) < 1e-5 * np.max(np.abs(want))


def _stats_case(case):
    if case == "scattered":
        return CSR.from_scipy(_rand(300, 400, 0.002, seed=7))
    if case == "blocks":
        return BSR.random_blocks(256, 192, (64, 64), 0.4, seed=2)
    if case == "duplicates":
        return COO(rows=np.array([0, 0, 70, 70], np.int32),
                   cols=np.array([3, 3, 100, 1], np.int32),
                   values=np.array([0.5, 0.25, 1.0, -1.0], np.float32),
                   shape=(80, 130))
    if case == "bf16_values":
        sp = _rand(150, 90, 0.05, seed=8)
        sp.data = np.sign(sp.data).astype(np.float32)
        return CSR.from_scipy(sp)
    return CSR.from_scipy(scipy.sparse.csr_matrix((70, 20), dtype=np.float32))


@pytest.mark.parametrize("case", ["scattered", "blocks", "duplicates",
                                  "bf16_values", "empty"])
def test_plan_stats_match_the_plan(case):
    """plan_stats, counted from the triplets, gives the tile count, nnz,
    fill and bytes of the plan block_plan builds."""
    a = _stats_case(case)
    stats = bs.plan_stats(a)
    plan = bs.block_plan(a)
    assert (stats.n_tiles, stats.nnz, stats.plan_bytes) == (
        plan.n_tiles, plan.nnz, plan.plan_bytes)
    assert stats.fill == pytest.approx(plan.fill)


def _cache_keys(a):
    from tpuspmm.ops.xla import coo_view

    return set(getattr(coo_view(a), "_xla_cache", {}))


def test_scattered_matrix_builds_no_plan():
    """A scattered matrix (one nonzero per 64×64 tile) is routed past the
    kernel from its stats alone: no tile is built on the default entry
    point."""
    import tpuspmm
    from tpuspmm.kernels import dispatch

    n = 4096
    idx = np.arange(0, n, 64, dtype=np.int32)
    a = COO(rows=np.repeat(idx, len(idx)), cols=np.tile(idx, len(idx)),
            values=np.ones(len(idx) ** 2, np.float32), shape=(n, n))
    assert bs.plan_stats(a).fill == 1 / (bs.BM * bs.BK)
    assert dispatch.choose_route(a, 8) != "blocksparse"
    b = _b(n, 8, "f32")
    out = np.asarray(tpuspmm.spmm(a, b))
    assert allclose(out, _ref(a, b), 1e-2, 1e-3)
    assert "plan_stats" in _cache_keys(a)
    assert "block_plan" not in _cache_keys(a)


@pytest.mark.parametrize("fmt", ["csr", "coo", "bsr", "ell"])
def test_plan_cap_refuses_the_kernel(fmt, monkeypatch):
    """A plan above the materialisation cap is refused by the dispatcher
    and by the registry variant, before any tile is built."""
    from tpuspmm.config import Config
    from tpuspmm.engine import registry
    from tpuspmm.kernels import dispatch

    a = convert.to_format(
        BSR.random_blocks(1024, 256, (64, 64), 0.3, seed=1).to_scipy(), fmt)
    b = _b(256, 16, "f32")
    cfg = Config(interpret=True)
    v = next(v for v in registry.get_engine(fmt).variants
             if v.name == "triton_blocksparse")
    assert dispatch.choose_route(a, 16, cfg) == "blocksparse"
    assert v.inadmissible_reason(a, b, cfg) == ""
    monkeypatch.setattr(registry, "GATHER_MAX_BYTES",
                        bs.plan_stats(a).plan_bytes - 1)
    assert dispatch.choose_route(a, 16, cfg) != "blocksparse"
    assert "admission" in v.inadmissible_reason(a, b, cfg)
    assert "block_plan" not in _cache_keys(a)
