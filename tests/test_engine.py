"""Engine-layer tests: format selection, dispatch routing, API surface."""

import numpy as np
import pytest

from tpuspmm.formats import CSR, BSR, convert
from tpuspmm.engine import select
from tpuspmm.engine.registry import get_engine, FORMATS
from tpuspmm.ops import oracle
from tpuspmm.utils.compare import allclose
import tpuspmm


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(0)
    a = CSR.random(150, 220, 0.05, seed=1)
    b = rng.standard_normal((220, 48)).astype(np.float32)
    return a, b, oracle.spmm_oracle(a, b)


def test_engines_exist_with_reference_variant_counts():
    """Reference: CSR=4, COO=1, BSR=1, ELL=1 kernels (SURVEY.md §2.1 N3);
    this build must have at least that many per format."""
    mins = {"csr": 4, "coo": 1, "bsr": 1, "ell": 1}
    for fmt in FORMATS:
        assert get_engine(fmt).num_kernels >= mins[fmt]


def test_run_kernel_numbering(small):
    """-1 = vendor, 0 = oracle, 1..N = variants (engine.cpp:16-61)."""
    a, b, ref = small
    eng = get_engine("csr")
    assert allclose(np.asarray(eng.run_kernel(0, a, b)), ref, 1e-6, 1e-6)
    assert allclose(np.asarray(eng.run_kernel(-1, a, b)), ref, 1e-2, 1e-3)
    for v in eng.variants:
        if not v.inadmissible_reason(a, b, tpuspmm.default_config()):
            out = np.asarray(eng.run_kernel(v.number, a, b))
            assert allclose(out, ref, 1e-2, 1e-3), v.name


def test_select_format_block_structure():
    a = BSR.random_blocks(256, 256, (128, 128), 0.3, seed=0).to_csr()
    fmt, kernel = select.select_format(a)
    assert fmt == "bsr"


def test_select_format_hyper_sparse():
    a = CSR.random(2000, 3000, 0.0005, seed=2)
    fmt, kernel = select.select_format(a)
    assert fmt in ("csr", "ell")


def test_auto_spmm_correct(small):
    a, b, ref = small
    out, fmt, kernel = select.auto_spmm(a, b)
    assert fmt in FORMATS
    assert allclose(np.asarray(out), ref, 1e-2, 1e-3)


def test_dispatch_routes_densify():
    """High density + affordable dense A → densify path."""
    from tpuspmm.kernels import dispatch

    a = CSR.random(256, 256, 0.2, seed=3)
    b = np.random.default_rng(0).standard_normal((256, 32)).astype(np.float32)
    assert dispatch.choose_route(a, 32) == "densify"
    out = np.asarray(dispatch.spmm_auto(a, b))
    assert allclose(out, oracle.spmm_oracle(a, b), 1e-2, 1e-3)


def test_dispatch_routes_hyper_sparse_to_xla():
    from tpuspmm.kernels import dispatch

    a = CSR.random(500, 4000, 0.0008, seed=4)
    b = np.random.default_rng(1).standard_normal((4000, 16)).astype(np.float32)
    assert dispatch.choose_route(a, 16) == "xla"
    out = np.asarray(dispatch.spmm_auto(a, b))
    assert allclose(out, oracle.spmm_oracle(a, b), 1e-2, 1e-3)


def test_spmv(small):
    a, b, ref = small
    x = b[:, 0]
    out = np.asarray(tpuspmm.spmv(a, x, method="xla"))
    assert out.shape == (a.shape[0],)
    assert allclose(out[:, None], ref[:, [0]], 1e-2, 1e-3)


def test_spmm_transpose(small):
    a, b, ref = small
    g = np.random.default_rng(5).standard_normal((a.shape[0], 8)).astype(np.float32)
    expect = a.to_dense().T.astype(np.float64) @ g
    for method in ("xla", "pallas"):  # backward must not downgrade off Pallas
        out = np.asarray(tpuspmm.spmm_transpose(a, g, method=method))
        assert allclose(out, expect, 1e-2, 1e-3), method


def test_spmm_fn_pallas_gradient():
    """spmm_fn's VJP runs the Pallas kernel end to end: the backward path
    goes through the same method as the forward."""
    import jax
    import jax.numpy as jnp

    a = CSR.random(200, 300, 0.05, seed=15, lo=-1, hi=1)
    b0 = np.random.default_rng(8).standard_normal((300, 32)).astype(np.float32)
    f = tpuspmm.spmm_fn(a, method="pallas")
    tgt = np.random.default_rng(9).standard_normal((200, 32)).astype(np.float32)

    def loss(b):
        r = f(b) - tgt
        return 0.5 * jnp.sum(r * r)

    g = np.asarray(jax.grad(loss)(jnp.asarray(b0)))
    ad = a.to_dense().astype(np.float64)
    res = ad @ b0 - tgt
    assert allclose(g, ad.T @ res, 1e-2, 1e-3)


def test_public_api_formats_round_trip(small):
    a, b, ref = small
    for fmt in FORMATS:
        m = convert.to_format(a, fmt)
        out = np.asarray(tpuspmm.spmm(m, b, method="xla"))
        assert allclose(out, ref, 1e-2, 1e-3), fmt


def test_timing_module_cpu():
    """time_ms returns the median of completed calls and the last result."""
    import jax.numpy as jnp

    from tpuspmm.utils import timing

    w = jnp.ones((64, 64))
    ms, out = timing.time_ms(
        lambda: jnp.dot(w, jnp.ones((64, 64)),
                        preferred_element_type=jnp.float32),
        warmup=1, repeats=3)
    assert ms > 0
    np.testing.assert_array_equal(np.asarray(out), np.full((64, 64), 64.0))


def test_timing_module_bf16_operand():
    """The timer is dtype-agnostic: a bf16-ingested operand times and
    returns its f32-accumulated result."""
    import jax.numpy as jnp

    from tpuspmm.utils import timing

    w = jnp.ones((64, 64), jnp.bfloat16)
    ms, out = timing.time_ms(
        lambda: jnp.dot(w, jnp.ones((64, 64), jnp.bfloat16),
                        preferred_element_type=jnp.float32), repeats=2)
    assert ms > 0 and out.dtype == jnp.float32


def test_spmm_fn_gradient_matches_dense():
    import jax
    import jax.numpy as jnp

    a = CSR.random(60, 80, 0.1, seed=6)
    b0 = np.random.default_rng(2).standard_normal((80, 16)).astype(np.float32)
    f = tpuspmm.spmm_fn(a, method="xla")
    tgt = np.random.default_rng(3).standard_normal((60, 16)).astype(np.float32)

    def loss(b):
        r = f(b) - tgt
        return 0.5 * jnp.sum(r * r)

    g = np.asarray(jax.grad(loss)(jnp.asarray(b0)))
    ad = a.to_dense().astype(np.float64)
    g_ref = ad.T @ (ad @ b0 - tgt)
    # framework gate tolerance (f32 forward/backward vs f64 reference,
    # A values span ±100 so absolute magnitudes are large)
    assert allclose(g, g_ref, 1e-2, 1e-3)


def test_runner_fault_is_errored_not_incorrect(small):
    """An exception during a variant run (e.g. out of memory) must
    produce correct:"" + error — never correct:"0", which the reference
    reserves for a completed allclose miss (spmm_csr_k1.cu:76-81) — and
    summarize must tally it in its own `errored` column, not `incorrect`."""
    from bench.summarize import summarize
    from tpuspmm.engine.registry import Engine, KernelVariant
    from tpuspmm.engine.runner import run_engine

    a, b, _ = small

    def boom(a_, b_, cfg):
        raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

    eng = Engine(fmt="csr", variants=[KernelVariant(1, "boom", boom)])
    records = run_engine(eng, a, b, testcase="t", repeats=1, emit=False,
                         run_vendor=False)
    rec = next(r for r in records if r["kernelName"] == "boom")
    assert rec["correct"] == "", rec
    assert "RESOURCE_EXHAUSTED" in rec["error"]
    rows = summarize(records)
    row = next(r for r in rows if r["testcase"] == "t")
    assert row["errored"] == 1
    assert row["incorrect"] == 0


def test_autotune_picks_and_caches(small):
    from tpuspmm.engine import autotune

    a, b, ref = small
    ranking = autotune.tune(a, b, repeats=2)
    assert ranking, "no variant tuned"
    assert hasattr(a, "_tune_cache") and a._tune_cache
    out = np.asarray(tpuspmm.spmm(a, b, method="tuned"))
    assert allclose(out, ref, 1e-2, 1e-3)


def test_autotune_excludes_gate_failing_variants(monkeypatch):
    """tune() must drop any variant whose result fails the oracle gate
    for this (matrix, operand), however fast it is."""
    import jax.numpy as jnp

    from tpuspmm.config import default_config
    from tpuspmm.engine import autotune, registry

    a = CSR.random(120, 160, 0.1, seed=811)
    b = np.random.default_rng(7).uniform(-1, 1, (160, 32)).astype(np.float32)
    ref = oracle.spmm_oracle(a, b)
    engine = get_engine("csr")
    wrong = registry.KernelVariant(
        99, "fast_but_wrong",
        lambda a_, b_, c_: jnp.zeros((a_.shape[0], b_.shape[1])))
    monkeypatch.setattr(engine, "variants", engine.variants + [wrong])
    ranking = autotune.tune(a, b, repeats=1, use_disk_cache=False)
    assert ranking
    assert "fast_but_wrong" not in {r.variant_name for r in ranking}
    cfg = default_config()
    for r in ranking:
        out = np.asarray(engine.run_kernel(r.number, a, b, cfg))
        assert allclose(out, ref, 1e-2, 1e-3), r.variant_name


def test_autotune_key_carries_serving_dtype(small):
    """A bf16-ingested ranking (--b-dtype bf16) must not be served for
    f32 operands or vice versa — the winners and the gate both differ —
    and tune() must measure on the ingested dtype, not silently upcast."""
    import ml_dtypes

    from tpuspmm.engine import autotune

    a, b, _ = small
    b16 = b.astype(ml_dtypes.bfloat16)
    assert autotune._disk_key(a, b) != autotune._disk_key(a, b16)
    assert autotune._tune_key(b) != autotune._tune_key(b16)
    ranking = autotune.tune(a, b16, repeats=1, use_disk_cache=False)
    assert ranking


def test_auto_spmm_wide_b_does_not_crash():
    """Regression: select_format assumed width 256; a wide B made the
    C-resident recommendation inadmissible and raised instead of falling
    back."""
    a = CSR.random(512, 512, 0.05, seed=9)
    b = np.random.default_rng(4).standard_normal((512, 4096)).astype(np.float32)
    out, fmt, kernel = select.auto_spmm(a, b)
    assert allclose(np.asarray(out), oracle.spmm_oracle(a, b), 1e-2, 1e-3)


def test_csc_vendor_and_tuned_paths():
    """Regression: CSC crashed through method='vendor' (TypeError) and
    method='tuned' (KeyError 'csc')."""
    from tpuspmm.formats import CSC

    a_csr = CSR.random(80, 120, 0.1, seed=11)
    a = CSC.from_scipy(a_csr.to_scipy())
    b = np.random.default_rng(5).standard_normal((120, 16)).astype(np.float32)
    ref = oracle.spmm_oracle(a_csr, b)
    assert allclose(np.asarray(tpuspmm.spmm(a, b, method="vendor")), ref, 1e-2, 1e-3)
    assert allclose(np.asarray(tpuspmm.spmm(a, b, method="tuned")), ref, 1e-2, 1e-3)


def test_select_format_width_sensitive():
    """The ELL gather recommendation must respect the actual B width: at
    a width whose (slots, width) intermediate exceeds the gather cap, ELL
    is not recommended, and every recommendation names a registered
    variant."""
    a = CSR.random(1000, 8000, 0.001, seed=12)  # even rows: ELL-friendly
    fmt_narrow, k_narrow = select.select_format(a, n_width=256)
    fmt_wide, k_wide = select.select_format(a, n_width=1 << 20)
    assert fmt_narrow == "ell"
    assert fmt_wide != "ell"
    for fmt, name in ((fmt_narrow, k_narrow), (fmt_wide, k_wide)):
        assert name in {v.name for v in get_engine(fmt).variants}


def test_autotune_vendor_competes_and_serves(small):
    """The vendor baseline (kernel -1, reference convention) competes in
    the tuned ranking, and spmm_tuned can serve it when it wins."""
    from tpuspmm.engine import autotune

    a, b, ref = small
    ranking = autotune.tune(a, b, repeats=1, use_disk_cache=False)
    names = {r.variant_name for r in ranking}
    assert "vendor_cusparse" in names
    # force the vendor to rank first: serving must route through
    # run_kernel(-1) and still pass the gate
    ranking.sort(key=lambda r: (r.number != -1, r.ms))
    assert ranking[0].number == -1
    a._tune_cache[autotune._tune_key(b)] = ranking
    served = np.asarray(autotune.spmm_tuned(a, b))
    assert allclose(served, ref, 1e-2, 1e-3)


def test_gather_family_admission_caps_materialized_intermediate():
    """The XLA gather+segment-sum lowering materializes an (nnz, n)
    intermediate; at large_20000's reference width (n=20000) that is
    ~11 GB.  The variant must skip (inadmissible) instead of attempting
    it."""
    from tpuspmm.engine import registry

    cfg = tpuspmm.default_config()
    a = CSR.random(100, 140, 0.08, seed=11)
    b_small = np.zeros((140, 64), np.float32)
    assert registry._gather_ok(a, b_small, cfg)
    # fake a huge width: nnz * n * 4 over the cap
    class WideB:
        shape = (140, registry.GATHER_MAX_BYTES // (4 * a.nnz) + 256)
    wide = np.zeros((1, 1), np.float32)  # placeholder; use shape shim
    assert not registry._gather_ok(
        a, np.broadcast_to(wide, (140, WideB.shape[1])), cfg)


def test_run_engine_bf16_ingested_operand(small):
    """CLI --b-dtype bf16 (the pruned-LLM serving mode): run_engine serves
    the bf16 operand as-is — every variant and the vendor baseline are
    gated against the f64 oracle OF THE bf16 VALUES, and records carry
    bDtype=bf16 so sweep artifacts distinguish the serving dtype."""
    import ml_dtypes

    from tpuspmm.engine.registry import get_engine
    from tpuspmm.engine.runner import run_engine

    a, b, _ = small
    b16 = b.astype(ml_dtypes.bfloat16)
    records = run_engine(get_engine("csr"), b=b16, a=a, testcase="t",
                         repeats=1, emit=False)
    assert records and all(r.get("bDtype") == "bf16" for r in records)
    bad = [r for r in records if r.get("correct") == "0"]
    assert not bad, bad
    # and an f32 operand is tagged explicitly (every record self-describes
    # its serving dtype)
    recs32 = run_engine(get_engine("csr"), b=b, a=a, testcase="t",
                        repeats=1, emit=False)
    assert recs32 and all(r.get("bDtype") == "f32" for r in recs32)
    assert all(r.get("bCols") == b.shape[1] for r in recs32)


def test_densify_variant_all_formats(small):
    """The cached-densify variant (densify once at plan time, serve one
    dense cuBLAS matmul per call) exists in every engine and is
    gate-exact; duplicates accumulate through the cache build."""
    import jax.numpy as jnp

    from tpuspmm.config import default_config
    from tpuspmm.engine.registry import get_engine
    from tpuspmm.formats import COO, convert
    from tpuspmm.ops import oracle
    from tpuspmm.utils.compare import allclose

    a, b, ref = small
    cfg = default_config()
    for fmt, num in (("csr", 2), ("coo", 4), ("bsr", 4), ("ell", 4)):
        eng = get_engine(fmt)
        v = eng.variant(num)
        assert v.name == "xla_densify_matmul", (fmt, v.name)
        af = convert.to_format(a, fmt)
        out = np.asarray(v.fn(af, b, cfg))
        assert allclose(out, ref, 1e-2, 1e-3), fmt
        # the dense operand is cached on the COO view after first serve
        from tpuspmm.ops.xla import coo_view

        assert "dense" in getattr(coo_view(af), "_xla_cache", {})
    # duplicate coordinates accumulate (COO semantics)
    c = COO(shape=(4, 4), rows=np.array([0, 0], np.int32),
            cols=np.array([1, 1], np.int32),
            values=np.array([1.5, 2.5], np.float32))
    out = np.asarray(get_engine("coo").variant(4).fn(
        c, np.eye(4, dtype=np.float32), cfg))
    assert out[0, 1] == 4.0


def test_spmm_method_densify(small):
    """Public spmm(method='densify') routes through the cached dense
    operand for every container kind, including formats outside the
    engine registry (CSC serves via its COO view)."""
    from tpuspmm.formats import convert
    from tpuspmm.ops.xla import coo_view

    a, b, ref = small
    for fmt in ("csr", "coo", "bsr", "ell", "csc"):
        af = convert.to_format(a, fmt)
        out = np.asarray(tpuspmm.spmm(af, b, method="densify"))
        assert allclose(out, ref, 1e-2, 1e-3), fmt
        assert "dense" in getattr(coo_view(af), "_xla_cache", {}), fmt




# ---------------------------------------------------------------------------
# registry numbering and admissibility
# ---------------------------------------------------------------------------

EXPECTED_NUMBERING = {
    "csr": ["xla_segment_sum", "xla_densify_matmul", "triton_blocksparse",
            "xla_compensated"],
    "coo": ["xla_segment_sum", "triton_blocksparse", "xla_compensated",
            "xla_densify_matmul"],
    "bsr": ["xla_block_einsum", "triton_blocksparse", "xla_compensated",
            "xla_densify_matmul"],
    "ell": ["xla_segment_sum", "triton_blocksparse", "xla_compensated",
            "xla_densify_matmul"],
}


@pytest.mark.parametrize("fmt", FORMATS)
def test_registry_numbering_contiguous(fmt):
    """Variants are numbered 1..N without gaps, in the documented order."""
    eng = get_engine(fmt)
    assert [v.number for v in eng.variants] == list(
        range(1, eng.num_kernels + 1))
    assert [v.name for v in eng.variants] == EXPECTED_NUMBERING[fmt]


@pytest.mark.parametrize("fmt", FORMATS)
def test_pallas_variant_inadmissible_on_cpu_without_interpret(fmt):
    """A Pallas GPU kernel on the CPU is inadmissible, with a reason,
    unless interpret mode is asked for — it never runs interpreted
    silently."""
    from tpuspmm.config import Config

    a = convert.to_format(CSR.random(40, 60, 0.1, seed=2), fmt)
    b = np.ones((60, 8), np.float32)
    v = next(v for v in get_engine(fmt).variants if v.requires_gpu)
    assert "needs a GPU" in v.inadmissible_reason(a, b, Config(interpret=False))
    assert v.inadmissible_reason(a, b, Config(interpret=True)) == ""


def test_runner_records_inadmissible_reason(small):
    """run_engine records an inadmissible variant with its reason and
    runs the rest."""
    from tpuspmm.config import Config
    from tpuspmm.engine.runner import run_engine

    a, b, _ = small
    records = run_engine(get_engine("csr"), a, b, testcase="t", repeats=1,
                         emit=False, config=Config(interpret=False),
                         run_vendor=False)
    skipped = [r for r in records if r.get("skipped") == "inadmissible"]
    assert [r["kernelName"] for r in skipped] == ["triton_blocksparse"]
    assert "needs a GPU" in skipped[0]["reason"]
    ran = [r for r in records if r["kernelType"] not in ("0",)
           and "skipped" not in r]
    assert ran and all(r["correct"] == "1" for r in ran)


def test_runner_timer_failure_is_an_error(small, monkeypatch):
    """A timer that raises makes the record an error — no other clock
    stands in for it."""
    from tpuspmm.engine.registry import Engine, KernelVariant
    from tpuspmm.engine.runner import run_engine

    a, b, ref = small

    def boom_timer(*a_, **k_):
        raise RuntimeError("timer failed")

    monkeypatch.setattr("tpuspmm.utils.timing.time_ms", boom_timer)
    eng = Engine(fmt="csr", variants=[KernelVariant(
        1, "good", lambda a_, b_, c_: tpuspmm.spmm(a_, b_, method="xla"))])
    records = run_engine(eng, a, b, testcase="t", repeats=1, emit=False,
                         run_vendor=False)
    rec = next(r for r in records if r["kernelName"] == "good")
    assert rec["correct"] == "" and "timer failed" in rec["error"]
    assert "kernelTimeMs" in rec and rec["kernelTimeMs"] == 0.0


# ---------------------------------------------------------------------------
# autotune cache keys
# ---------------------------------------------------------------------------

def test_autotune_key_carries_device_and_engine(small, monkeypatch):
    """Disk rankings are keyed by the device kind and the variant set:
    a ranking measured on one device or registry is never served on
    another."""
    from tpuspmm.engine import autotune

    a, b, _ = small
    k_cpu = autotune._disk_key(a, b)
    assert ":cpu:" in k_cpu
    monkeypatch.setattr("tpuspmm.config.device_kind",
                        lambda: "NVIDIA H100 80GB HBM3")
    assert autotune._disk_key(a, b) != k_cpu
    monkeypatch.setattr(autotune, "_engine_rev", lambda fmt: "other")
    assert ":eother" in autotune._disk_key(a, b)


def test_autotune_disk_cache_roundtrip(tmp_path, monkeypatch):
    """A second process (fresh container, same digest) is served the
    stored ranking without measuring anything."""
    from tpuspmm.engine import autotune
    from tpuspmm.utils import timing

    monkeypatch.setenv("TPUSPMM_TUNE_CACHE", str(tmp_path / "tune.json"))
    a = CSR.random(90, 120, 0.1, seed=7)
    b = np.random.default_rng(1).standard_normal((120, 16)).astype(np.float32)
    first = autotune.tune(a, b, repeats=1)
    assert first

    def no_measuring(*a_, **k_):
        raise AssertionError("a cached ranking must not be re-measured")

    monkeypatch.setattr(timing, "time_ms", no_measuring)
    a2 = CSR(a.indptr, a.indices, a.values, a.shape)
    second = autotune.tune(a2, b, repeats=1)
    assert [r.variant_name for r in second] == [r.variant_name for r in first]


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _route_case(name):
    import scipy.sparse

    from tpuspmm.formats import COO

    if name == "exact":  # extreme values → compensated accumulation
        return CSR.from_scipy(scipy.sparse.random(
            60, 80, density=0.05, random_state=1, format="csr",
            data_rvs=lambda n: np.full(n, 1e7)))
    if name == "densify":
        return CSR.random(128, 128, 0.3, seed=1)
    if name == "blocksparse":  # dense 64x64 blocks: well-filled tiles
        return BSR.random_blocks(1024, 256, (64, 64), 0.3, seed=1)
    if name == "xla":
        return CSR.random(400, 3000, 0.0008, seed=4)
    # vendor: the gather intermediate does not fit at this width
    return COO(rows=np.arange(2000, dtype=np.int32) % 50,
               cols=np.arange(2000, dtype=np.int32) % 4000,
               values=np.ones(2000, np.float32), shape=(50, 4000))


@pytest.mark.parametrize("route", ["exact", "densify", "blocksparse", "xla",
                                   "vendor"])
def test_dispatch_choice(route, monkeypatch):
    """choose_route picks each route where the measured thresholds say
    it should, and spmm_auto serves it correctly."""
    from tpuspmm.engine import registry
    from tpuspmm.kernels import dispatch

    a = _route_case(route)
    n = 16
    if route == "vendor":
        monkeypatch.setattr(registry, "GATHER_MAX_BYTES", 1024)
    assert dispatch.choose_route(a, n) == route
    b = np.random.default_rng(0).uniform(-1, 1, (a.shape[1], n)).astype(
        np.float32)
    out = np.asarray(dispatch.spmm_auto(a, b))
    assert allclose(out, oracle.spmm_scipy_oracle(a, b), 1e-2, 1e-3)


@pytest.mark.parametrize("density,n,route", [
    (0.1, 128, "vendor"),         # 128 programs: densify/cuSPARSE win
    (0.1, 512, "blocksparse"),    # 512 programs
    (0.1, 1024, "blocksparse"),
    (0.005, 1024, "xla"),         # tiles 0.5% full
])
def test_h100_dispatch_needs_fill_and_a_full_grid(density, n, route,
                                                  monkeypatch):
    """On the H100 row the kernel serves only where its tiles are filled
    and its grid (row blocks × column tiles) fills the card — the two
    conditions the density sweeps measured."""
    from tpuspmm.config import Config
    from tpuspmm.kernels import dispatch

    a = CSR.random(8192, 64, density, seed=5)
    monkeypatch.setattr("tpuspmm.config.platform", lambda: "gpu")
    monkeypatch.setattr("tpuspmm.config.device_kind",
                        lambda: "NVIDIA H100 80GB HBM3")
    assert dispatch.choose_route(a, n, Config(interpret=True)) == route


def test_dispatch_thresholds_unknown_gpu_raises(monkeypatch):
    """A GPU the threshold table does not hold is an error, not a
    default row."""
    from tpuspmm.kernels import dispatch

    monkeypatch.setattr("tpuspmm.config.platform", lambda: "gpu")
    monkeypatch.setattr("tpuspmm.config.device_kind", lambda: "Some GPU")
    with pytest.raises(KeyError, match="Some GPU"):
        dispatch.thresholds()
    monkeypatch.setattr("tpuspmm.config.device_kind",
                        lambda: "NVIDIA H100 80GB HBM3")
    assert dispatch.thresholds()["densify_min_density"] > 0


# ---------------------------------------------------------------------------
# vendor lowering, records, device helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_vendor_lowering_recorded(fmt, small):
    """spmm_vendor records the lowering it compiled: BCSR for CSR, BCOO
    for the rest; on the CPU the program holds no cuSPARSE call."""
    from tpuspmm.ops import vendor

    a, b, ref = small
    af = convert.to_format(a, fmt)
    out = np.asarray(vendor.spmm_vendor(af, b))
    assert allclose(out, ref, 1e-2, 1e-3)
    kind = "bcsr" if fmt == "csr" else "bcoo"
    assert vendor.last_lowering(af) == f"xla_{kind}"


@pytest.mark.parametrize("case", ["cpu", "h100_sxm", "h100_pcie",
                                  "unknown_gpu"])
def test_report_roofline_fields(case, monkeypatch):
    """The peak table holds the H100's data-sheet bandwidth by
    device_kind; the CPU gets no roofline field; an unknown GPU is an
    error."""
    from tpuspmm.engine import report

    kind = {"cpu": "cpu", "h100_sxm": "NVIDIA H100 80GB HBM3",
            "h100_pcie": "NVIDIA H100 PCIe", "unknown_gpu": "Some GPU"}[case]
    platform = "cpu" if case == "cpu" else "gpu"
    monkeypatch.setattr(report, "device_fields", lambda: {
        "platform": platform, "deviceKind": kind, "card": ""})
    kw = dict(testcase="t", sparsity=0.1, fmt="csr", kernel_type=1,
              nnz=1000, shape=(100, 100), n=32, kernel_ms=0.01)
    if case == "unknown_gpu":
        with pytest.raises(KeyError, match="Some GPU"):
            report.make_record(**kw)
        return
    rec = report.make_record(**kw)
    assert rec["gflops"] > 0 and rec["deviceKind"] == kind
    if case == "cpu":
        assert "memRooflineFraction" not in rec
        return
    peak = {"h100_sxm": 3.35e12, "h100_pcie": 2.0e12}[case]
    want = report.spmm_min_bytes(1000, 100, 100, 32) / peak / 1e-5
    assert rec["memRooflineFraction"] == pytest.approx(want)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR is obeyed when set (nothing else is set
    in code); otherwise the cache goes to the checkout's .jax_cache/."""
    import jax

    from tpuspmm import config

    set_calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: set_calls.append((k, v)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert config.enable_compile_cache() == str(tmp_path)
        assert set_calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = config.enable_compile_cache(str(tmp_path))
        assert path == str(tmp_path / ".jax_cache")
        assert set_calls == [("jax_compilation_cache_dir", path)]


@pytest.mark.parametrize("arg,env,want", [
    (True, None, True), (False, "1", False), (None, "1", True),
    (None, None, False)])
def test_should_interpret(arg, env, want, monkeypatch):
    """Interpret mode only when asked: an explicit argument wins, else
    TPUSPMM_INTERPRET=1; never chosen from the platform."""
    from tpuspmm.config import should_interpret

    if env is None:
        monkeypatch.delenv("TPUSPMM_INTERPRET", raising=False)
    else:
        monkeypatch.setenv("TPUSPMM_INTERPRET", env)
    assert should_interpret(arg) is want


def test_describe_device_on_the_cpu(monkeypatch):
    """describe_device names the platform, kind and count; without
    nvidia-smi the card field is empty, never invented."""
    from tpuspmm import config

    monkeypatch.setenv("PATH", "")
    d = config.describe_device()
    assert d["platform"] == "cpu" and d["count"] == 8
    assert d["card"] == ""


def test_time_ms_propagates_failures():
    """The timer does not swallow a failing call."""
    from tpuspmm.utils.timing import time_ms

    def boom():
        raise RuntimeError("device fault")

    with pytest.raises(RuntimeError, match="device fault"):
        time_ms(boom)
