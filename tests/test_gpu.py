"""Tests that need a GPU: the compiled Triton kernel, the cuSPARSE
lowering, the device tables.  They skip on the CPU (the ``gpu`` fixture
decides when the test runs, never at import).  Run them on a card with

    TPUSPMM_TEST_GPU=1 python -m pytest tests/ -m gpu

(phase 6 of chip_smoke.py runs them inside its own process).
"""

import ml_dtypes
import numpy as np
import pytest
import scipy.sparse

from tpuspmm.formats import convert
from tpuspmm.ops import oracle
from tpuspmm.utils.compare import allclose

pytestmark = pytest.mark.gpu


def _case(fmt, m=300, k=500, n=96, density=0.03, dtype="f32", seed=0):
    rng = np.random.default_rng(seed)
    sp = scipy.sparse.random(m, k, density=density, format="csr",
                             random_state=rng,
                             data_rvs=lambda s: rng.uniform(-10, 10, s))
    a = convert.to_format(sp, fmt)
    b = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    if dtype == "bf16":
        b = b.astype(ml_dtypes.bfloat16)
    return a, b, oracle.spmm_scipy_oracle(a, np.asarray(b).astype(np.float64))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["csr", "coo", "bsr", "ell"])
def test_kernel_compiled_matches_oracle(gpu, fmt, dtype):
    """The Triton kernel compiled for the card, every format, both B
    dtypes, M/K/N not tile multiples."""
    from tpuspmm.kernels import blocksparse_gpu as bs

    a, b, ref = _case(fmt, dtype=dtype, n=77)
    out = np.asarray(bs.spmm_blocksparse(a, b, interpret=False))
    assert allclose(out, ref, 1e-2, 1e-3)


@pytest.mark.parametrize("bm,bk,n", [(16, 16, 300), (64, 64, 40),
                                     (128, 64, 128)])
def test_kernel_geometries_compile(gpu, bm, bk, n):
    """Plans of the tile shapes bench/kernel_compare.py sweeps compile and
    serve, at widths that pick different column tiles."""
    from bench.kernel_compare import plan_of
    from tpuspmm.kernels import blocksparse_gpu as bs

    a, b, ref = _case("csr", density=0.1, seed=bm, n=n)
    out = np.asarray(bs.spmm_blocksparse(plan_of(a, bm, bk), b))
    assert allclose(out, ref, 1e-2, 1e-3)


@pytest.mark.parametrize("fmt,kind", [("csr", "cusparse_bcsr"),
                                      ("coo", "cusparse_bcoo"),
                                      ("bsr", "cusparse_bcoo"),
                                      ("ell", "cusparse_bcoo")])
def test_vendor_lowers_to_cusparse(gpu, fmt, kind):
    from tpuspmm.ops import vendor

    a, b, ref = _case(fmt)
    out = np.asarray(vendor.spmm_vendor(a, b))
    assert allclose(out, ref, 1e-2, 1e-3)
    assert vendor.last_lowering(a) == kind


def test_device_tables_hold_this_card(gpu):
    """The peak and dispatch tables know the card JAX reports."""
    from tpuspmm.engine import report
    from tpuspmm.kernels import dispatch

    assert report.peak_mem_bytes_per_s("gpu", gpu.device_kind) > 1e12
    assert dispatch.thresholds()["blocksparse_min_fill"] > 0


def test_auto_and_tuned_serve_on_the_card(gpu):
    import tpuspmm

    a, b, ref = _case("csr", density=0.05)
    for method in ("auto", "tuned", "pallas", "vendor", "densify"):
        out = np.asarray(tpuspmm.spmm(a, b, method=method))
        assert allclose(out, ref, 1e-2, 1e-3), method


def test_blocksparse_local_on_a_mesh(gpu):
    """The block-sparse local compiles inside shard_map over the card(s)."""
    import jax

    from tpuspmm.parallel import make_mesh, spmm_row_sharded

    a, b, ref = _case("csr")
    mesh = make_mesh((len(jax.devices()),), ("rows",))
    out = np.asarray(spmm_row_sharded(a, b, mesh, local="blocksparse"))
    assert allclose(out, ref, 1e-2, 1e-3)


def test_cli_records_on_the_card(gpu, capsys):
    """The CLI's records on the card: every run correct, none
    interpreted, the vendor lowered to cuSPARSE."""
    import json

    from tpuspmm import cli

    rc = cli.main(["--csr", "--coo", "-d", "small_32x32", "--repeats", "2"])
    recs = [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]
    assert rc == 0
    ran = [r for r in recs if "skipped" not in r]
    assert ran and all(r["correct"] == "1" for r in ran)
    assert all(r.get("interpreted", "0") == "0" for r in recs)
    assert all(r["vendorLowering"].startswith("cusparse")
               for r in recs if r["kernelType"] == "-1")
