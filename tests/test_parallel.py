"""Distributed-layer tests on the 8-virtual-CPU-device mesh (conftest).

The reference has nothing distributed to mirror (SURVEY.md §0); these gate
the new-build capability: every schedule must match the numpy oracle at the
reference tolerance (rel 1e-2 / abs 1e-3, reference/include/utils.hpp:10-11).
"""

import numpy as np
import pytest

import jax

from tpuspmm.formats import CSR
from tpuspmm.ops import oracle
from tpuspmm.parallel import (
    make_mesh,
    spmm_row_sharded,
    spmm_ring,
    spmm_2d,
    lsq_train_step,
    make_train_state,
)
from tpuspmm.utils.compare import allclose


@pytest.fixture(scope="module")
def problem(rng=None):
    rng = np.random.default_rng(7)
    a = CSR.random(300, 420, 0.05, seed=3)
    b = rng.standard_normal((420, 96)).astype(np.float32)
    ref = oracle.spmm_oracle(a, b)
    return a, b, ref


def test_row_sharded_xla(problem):
    a, b, ref = problem
    mesh = make_mesh((4,), ("rows",))
    out = np.asarray(spmm_row_sharded(a, b, mesh, local="xla"))
    assert allclose(out, ref, 1e-2, 1e-3)


def test_ring(problem):
    a, b, ref = problem
    mesh = make_mesh((8,), ("rows",))
    out = np.asarray(spmm_ring(a, b, mesh))
    assert out.shape == ref.shape
    assert allclose(out, ref, 1e-2, 1e-3)


def test_ring_uneven_shapes():
    # M, K deliberately not multiples of shard counts
    rng = np.random.default_rng(11)
    a = CSR.random(97, 205, 0.08, seed=5)
    b = rng.standard_normal((205, 40)).astype(np.float32)
    ref = oracle.spmm_oracle(a, b)
    mesh = make_mesh((4,), ("rows",))
    out = np.asarray(spmm_ring(a, b, mesh))
    assert allclose(out, ref, 1e-2, 1e-3)


def test_2d_mesh(problem):
    a, b, ref = problem
    mesh = make_mesh((4, 2))
    out = np.asarray(spmm_2d(a, b, mesh))
    assert out.shape == ref.shape
    assert allclose(out, ref, 1e-2, 1e-3)


def test_weak_scaling_consistency(problem):
    """Same matrix, different shard counts → identical results."""
    a, b, ref = problem
    outs = []
    for n in (1, 2, 8):
        mesh = make_mesh((n,), ("rows",))
        outs.append(np.asarray(spmm_row_sharded(a, b, mesh, local="xla")))
    for o in outs:
        assert allclose(o, ref, 1e-2, 1e-3)


def test_lsq_train_step_descends():
    a = CSR.random(120, 200, 0.1, seed=9)
    mesh = make_mesh((4, 2))
    state = make_train_state(a, n=64, mesh=mesh, seed=1)
    losses = []
    for _ in range(3):
        state, loss = lsq_train_step(state, mesh, lr=1e-7)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_train_grad_matches_autodiff():
    """dB from the hand-written transpose SpMM must equal jax.grad of the
    densified loss."""
    import jax.numpy as jnp

    a = CSR.random(40, 60, 0.2, seed=2)
    mesh = make_mesh((2, 2))
    state = make_train_state(a, n=32, mesh=mesh, seed=4)
    meta = state["meta"]
    a_dense = np.zeros((meta["m_local"] * mesh.shape["rows"], meta["k_pad"]), np.float32)
    ad = a.to_dense()
    a_dense[: ad.shape[0], : ad.shape[1]] = ad
    b0 = np.asarray(state["b"])
    c_t = np.asarray(state["c_target"])

    def loss_fn(bmat):
        r = a_dense @ bmat - c_t
        return 0.5 * jnp.sum(r * r)

    g = np.asarray(jax.grad(loss_fn)(jnp.asarray(b0)))
    lr = 1e-2
    new_state, _ = lsq_train_step(state, mesh, lr=lr)
    db = (b0 - np.asarray(new_state["b"])) / lr
    np.testing.assert_allclose(db, g, rtol=1e-3, atol=1e-4)


def test_multihost_single_process_degrades():
    from tpuspmm.parallel import multihost

    info = multihost.process_info()
    assert info["process_count"] == 1
    assert info["global_devices"] == 8
    assert multihost.initialize() is False  # no coordinator: nothing to join
    mesh = multihost.global_mesh(("rows",))
    assert mesh.shape["rows"] == 8
    mesh2 = multihost.global_mesh(("rows", "cols"), shape=(4, 2))
    assert mesh2.shape == {"rows": 4, "cols": 2}


def test_profiling_trace_noop(tmp_path):
    from tpuspmm.utils.profiling import trace

    with trace(str(tmp_path / "trace")):
        pass  # must not raise even if the profiler is unavailable


def test_kshard_reduce_scatter(problem):
    from tpuspmm.parallel import spmm_kshard

    a, b, ref = problem
    mesh = make_mesh((4,), ("rows",))
    out = np.asarray(spmm_kshard(a, b, mesh))
    assert out.shape == ref.shape
    assert allclose(out, ref, 1e-2, 1e-3)


def test_kshard_uneven():
    rng = np.random.default_rng(13)
    a = CSR.random(101, 333, 0.07, seed=8)
    b = rng.standard_normal((333, 24)).astype(np.float32)
    ref = np.asarray(__import__("tpuspmm").spmm(a, b, method="oracle"))
    from tpuspmm.parallel import spmm_kshard

    mesh = make_mesh((8,), ("rows",))
    out = np.asarray(spmm_kshard(a, b, mesh))
    assert allclose(out, ref, 1e-2, 1e-3)


def test_ring_2d_cols_axis(problem):
    """Ring over "rows" with B/C column-sharded over "cols"."""
    from tpuspmm.parallel import spmm_ring

    a, b, ref = problem
    mesh = make_mesh((4, 2))
    out = np.asarray(spmm_ring(a, b, mesh, cols_axis="cols"))
    assert out.shape == ref.shape
    assert allclose(out, ref, 1e-2, 1e-3)


def test_2d_mesh_wide_b_not_multiple_of_tile():
    """Regression: B width giving per-device n_local=640 (not a multiple
    of the 512 column tile) used to leave columns 512+ unwritten (NaN)."""
    rng = np.random.default_rng(17)
    a = CSR.random(96, 128, 0.1, seed=6)
    b = rng.standard_normal((128, 1280)).astype(np.float32)
    ref = oracle.spmm_oracle(a, b)
    mesh = make_mesh((4, 2))
    out = np.asarray(spmm_2d(a, b, mesh))
    assert not np.isnan(out).any()
    assert allclose(out, ref, 1e-2, 1e-3)


def test_sharded_schedules_bf16_ingested_operand(problem):
    """bf16-ingested B (--b-dtype bf16 serving mode) through every
    communicating schedule: output stays f32, and the gate checks vs the
    f64 oracle OF the bf16 values."""
    import ml_dtypes

    from tpuspmm.parallel import spmm_kshard

    a, b, _ = problem
    b16 = b.astype(ml_dtypes.bfloat16)
    ref16 = oracle.spmm_oracle(a, np.asarray(b16).astype(np.float64))
    mesh = make_mesh((8,), ("rows",))
    for fn in (spmm_row_sharded, spmm_kshard, spmm_ring):
        out = np.asarray(fn(a, b16, mesh))
        assert out.dtype == np.float32, fn.__name__
        assert allclose(out, ref16, 1e-2, 1e-3), fn.__name__
    # and the block-sparse kernel as the communicating schedules' local
    for fn in (spmm_kshard, spmm_ring):
        out = np.asarray(fn(a, b16, mesh, local="blocksparse"))
        assert allclose(out, ref16, 1e-2, 1e-3), fn.__name__


# ---------------------------------------------------------------------------
# the block-sparse local compute (Triton kernel, interpreted here)
# ---------------------------------------------------------------------------

def _skewed():
    """Ragged M/K with wildly uneven bucket occupancy: 90% of nnz in
    K < 64, so some buckets are nearly empty and the uniform-padding of
    the stacked plans is exercised."""
    from tpuspmm.formats import COO

    rng = np.random.default_rng(13)
    m, k = 97, 205
    n1, n2 = 360, 40
    rows = np.concatenate([rng.integers(0, m, n1), rng.integers(0, m, n2)])
    cols = np.concatenate([rng.integers(0, 64, n1), rng.integers(64, k, n2)])
    vals = rng.standard_normal(n1 + n2).astype(np.float32)
    a = COO(shape=(m, k), rows=rows.astype(np.int32),
            cols=cols.astype(np.int32), values=vals)
    b = rng.standard_normal((k, 40)).astype(np.float32)
    return a, b, oracle.spmm_oracle(a, b)


SCHEDULES = {
    "row": lambda a, b, **kw: spmm_row_sharded(a, b, make_mesh((4,), ("rows",)), **kw),
    "2d": lambda a, b, **kw: spmm_2d(a, b, make_mesh((2, 2)), **kw),
    "ring": lambda a, b, **kw: spmm_ring(a, b, make_mesh((4,), ("rows",)), **kw),
    "ring_cols": lambda a, b, **kw: spmm_ring(a, b, make_mesh((2, 2)),
                                              cols_axis="cols", **kw),
    "kshard": lambda a, b, **kw: __import__(
        "tpuspmm.parallel", fromlist=["spmm_kshard"]).spmm_kshard(
            a, b, make_mesh((4,), ("rows",)), **kw),
}


@pytest.mark.parametrize("case", ["even", "skewed"])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_blocksparse_local(problem, schedule, case):
    """Every schedule serves the block-sparse kernel as its local
    compute, on the even problem and on ragged, skewed buckets."""
    a, b, ref = problem if case == "even" else _skewed()
    out = np.asarray(SCHEDULES[schedule](a, b, local="blocksparse",
                                         interpret=True))
    assert out.shape == ref.shape
    assert allclose(out, ref, 1e-2, 1e-3)


@pytest.mark.parametrize("schedule", ["row", "2d", "ring", "kshard"])
def test_unknown_local_raises(problem, schedule):
    a, b, _ = problem
    with pytest.raises(ValueError, match="local must be one of"):
        SCHEDULES[schedule](a, b, local="tile")


def test_default_local_is_xla(problem, monkeypatch):
    """Without a local argument no schedule reaches the Pallas kernel."""
    from tpuspmm.kernels import blocksparse_gpu

    def no_kernel(*a_, **k_):
        raise AssertionError("the default local must not call the kernel")

    monkeypatch.setattr(blocksparse_gpu, "blocksparse_call", no_kernel)
    a, b, ref = problem
    for name, fn in SCHEDULES.items():
        assert allclose(np.asarray(fn(a, b)), ref, 1e-2, 1e-3), name


def test_blocksparse_local_bf16_plans():
    """±1 values: every shard's plan stores bf16 tiles losslessly and the
    stack shards and serves unchanged; one f32 shard makes the stack f32."""
    import ml_dtypes

    from tpuspmm.formats import COO
    from tpuspmm.parallel.shard import bucket_blockplans

    rng = np.random.default_rng(21)
    m, k, per_row = 300, 420, 5
    rows = np.repeat(np.arange(m, dtype=np.int32), per_row)
    cols = rng.integers(0, k, m * per_row).astype(np.int32)
    vals = rng.choice([-1.0, 1.0], m * per_row).astype(np.float32)
    a = COO(shape=(m, k), rows=rows, cols=cols, values=vals)
    b = rng.standard_normal((k, 96)).astype(np.float32)
    plans = bucket_blockplans(a, 8, 1)
    assert plans.tiles.dtype == ml_dtypes.bfloat16
    out = np.asarray(spmm_row_sharded(a, b, make_mesh((8,), ("rows",)),
                                      local="blocksparse", plan=plans,
                                      interpret=True))
    assert allclose(out, oracle.spmm_oracle(a, b), 1e-2, 1e-3)
    vals2 = vals.copy()
    vals2[0] = 0.1  # not bf16-exact, in shard 0 only
    a2 = COO(shape=(m, k), rows=rows, cols=cols, values=vals2)
    assert bucket_blockplans(a2, 8, 1).tiles.dtype == np.float32


def test_stacked_blockplans_shapes():
    """Stacked plans: one row_ptr per local problem over the same row
    blocks, tiles padded to a common count that no run reaches."""
    from tpuspmm.parallel.shard import bucket_blockplans

    a, _, _ = _skewed()
    plans = bucket_blockplans(a, 2, 3, m_align=4)
    assert plans.row_ptr.shape[:2] == (2, 3)
    assert plans.m_local % 4 == 0 and plans.m_local % plans.bm == 0
    n_tiles = plans.kt.shape[2]
    assert plans.tiles.shape == (2, 3, n_tiles * plans.bm, plans.bk)
    assert np.all(plans.row_ptr[..., -1] <= n_tiles)
    assert plans.k_local * 3 >= a.shape[1]


def test_ring_and_kshard_reject_mismatched_prebuilt_plans(problem):
    """Triplet buckets parameterize the xla local and block plans the
    blocksparse local; passing the other kind raises instead of silently
    rebuilding a different plan."""
    from tpuspmm.parallel import spmm_kshard
    from tpuspmm.parallel.shard import bucket_blockplans, bucket_triplets

    a, b, _ = problem
    mesh = make_mesh((8,), ("rows",))
    with pytest.raises(ValueError, match="plans="):
        spmm_ring(a, b, mesh, buckets=bucket_triplets(a, 8, 8),
                  local="blocksparse")
    with pytest.raises(ValueError, match="plans="):
        spmm_kshard(a, b, mesh, buckets=bucket_triplets(a, 1, 8),
                    local="blocksparse")
    with pytest.raises(ValueError, match="buckets="):
        spmm_ring(a, b, mesh, plans=bucket_blockplans(a, 8, 8))
