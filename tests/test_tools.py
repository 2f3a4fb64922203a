"""Offline-tooling tests: converter round-trips, generator, validator.

Mirrors the reference's tier-2 validation (scipy oracle + golden files,
SURVEY.md §4) as actual unit tests.
"""

import os

import numpy as np
import pytest
import scipy.io
import scipy.sparse

from tpuspmm.formats import CSR, COO, BSR, ELL, convert
from tpuspmm.formats import io as fio
from tpuspmm.tools.convert_mtx import convert_dir
from tpuspmm.tools.gen_sparse import gen_dir
from tpuspmm.tools.validate import compute_expect, write_expect, read_result, validate_dir


@pytest.fixture()
def mtx_dir(tmp_path):
    """A data dir with a sparse .mtx and a dense.mtx, reference-style."""
    rng = np.random.default_rng(0)
    sp = scipy.sparse.random(24, 36, density=0.15, format="coo", random_state=rng,
                             data_rvs=lambda n: rng.uniform(-10, 10, n))
    scipy.io.mmwrite(str(tmp_path / "testmat.mtx"), sp)
    dense = rng.uniform(-1, 1, (36, 8)).astype(np.float32)
    scipy.io.mmwrite(str(tmp_path / "dense.mtx"), dense)
    return str(tmp_path), sp, dense


def test_convert_dir_all_formats(mtx_dir):
    d, sp, dense = mtx_dir
    written = convert_dir(d, block_size=4)
    names = {os.path.basename(w) for w in written}
    assert {"testmat.csr", "testmat.coo", "testmat.bsr",
            "testmat_rowind.ell", "testmat_values_colmajor.ell",
            "testmat_colind.ell", "testmat_values.ell", "dense.in"} <= names

    ref = sp.toarray()
    assert np.allclose(CSR.from_file(os.path.join(d, "testmat.csr")).to_dense(), ref, atol=1e-5)
    assert np.allclose(COO.from_file(os.path.join(d, "testmat.coo")).to_dense(), ref, atol=1e-5)
    assert np.allclose(BSR.from_file(os.path.join(d, "testmat.bsr")).to_dense(), ref, atol=1e-5)
    ell = ELL.from_file(os.path.join(d, "testmat_rowind.ell"),
                        os.path.join(d, "testmat_values_colmajor.ell"))
    assert np.allclose(ell.to_dense(), ref, atol=1e-5)
    got_dense = fio.read_dense_text(os.path.join(d, "dense.in"))
    assert np.allclose(got_dense, dense, atol=1e-5)


def test_convert_bsr_nontrivial_blocks(mtx_dir):
    """The converter must honour real block sizes (the reference forces
    1×1, reference convert_mtx.py:22 — a quirk we don't replicate)."""
    d, sp, _ = mtx_dir
    convert_dir(d, block_size=4, formats=["bsr"])
    b = BSR.from_file(os.path.join(d, "testmat.bsr"))
    assert b.block_size == (4, 4)


def test_gen_sparse_dir(tmp_path):
    d = gen_dir(str(tmp_path), 0.3, 64, 64, 16, seed=1)
    a = CSR.from_file(os.path.join(d, "sparse.csr"))
    coo = COO.from_file(os.path.join(d, "sparse.coo"))
    b = fio.read_dense_text(os.path.join(d, "dense.in"))
    assert a.shape == (64, 64)
    assert b.shape == (64, 16)
    assert np.allclose(a.to_dense(), coo.to_dense(), atol=1e-5)
    assert 0.2 < a.sparsity < 0.4


def test_validate_round_trip(mtx_dir, tmp_path):
    d, sp, dense = mtx_dir
    expect = compute_expect(d)
    assert np.allclose(expect, sp.toarray() @ dense, rtol=1e-4, atol=1e-5)
    path = write_expect(d, expect)
    back = read_result(path)
    assert np.allclose(back, expect, atol=1e-6)

    # a correct .out passes, a corrupted one fails (headerless layout,
    # matching the reference's committed coo.out fixtures)
    def write_out(name, mat):
        with open(os.path.join(d, name), "w") as f:
            for row in mat:
                f.write(" ".join(f"{v:.10f}" for v in row) + "\n")

    write_out("good.out", expect)
    assert validate_dir(d) == 0
    bad = expect.copy()
    bad[0, 0] += 100.0
    write_out("bad.out", bad)
    assert validate_dir(d) == 1


def test_reference_golden_expect(small10_dir):
    """Our oracle must reproduce the reference's committed result.expect
    (reference/data/small_10x10/result.expect, golden fixture per
    SURVEY.md §4 tier 2)."""
    expect_path = os.path.join(small10_dir, "result.expect")
    if not os.path.exists(expect_path):
        pytest.skip("golden file missing")
    golden = read_result(expect_path)
    ours = compute_expect(small10_dir)
    assert ours.shape == golden.shape
    assert np.allclose(ours, golden, rtol=1e-6, atol=1e-6)


def test_converted_files_loadable_by_cli_discovery(mtx_dir):
    d, _, _ = mtx_dir
    convert_dir(d)
    found = convert.discover(d)
    assert found["csr"] and found["coo"] and found["bsr"]
    assert found["ell_rowind"] and found["ell_values"] and found["dense"]


def test_splice_sweep_replaces_groups(tmp_path):
    """splice_sweep: part-file groups replace their counterparts in the
    artifact (the re-run repair path); other groups survive."""
    import json

    from bench.splice_sweep import splice

    into = tmp_path / "full.jsonl"
    part = tmp_path / "part.jsonl"
    into.write_text("\n".join(json.dumps(r) for r in [
        {"testcase": "a", "format": "csr", "kernelName": "old1"},
        {"testcase": "a", "format": "csr", "kernelName": "old2"},
        {"testcase": "a", "format": "coo", "kernelName": "keep"},
        {"testcase": "b", "format": "csr", "kernelName": "keep"},
    ]) + "\n")
    part.write_text(json.dumps(
        {"testcase": "a", "format": "csr", "kernelName": "new"}) + "\n")
    out = splice(str(into), str(part))
    recs = [json.loads(l) for l in into.read_text().splitlines()]
    names = [r["kernelName"] for r in recs]
    assert out["records_dropped"] == 2 and out["records_added"] == 1
    assert "new" in names and "old1" not in names and "old2" not in names
    assert names.count("keep") == 2


def test_example_pruned_mlp_bf16(monkeypatch):
    """The end-to-end example must stay runnable: bf16 activations,
    unsharded path, small dims (interpret mode via conftest)."""
    import runpy
    import sys

    monkeypatch.setattr(sys, "argv", [
        "pruned_mlp", "--d-model", "64", "--d-ff", "128", "--batch", "32",
        "--block-sparsity", "0.8", "--activations-dtype", "bf16",
        "--method", "auto"])
    monkeypatch.setenv("TPUSPMM_INTERPRET", "1")
    try:
        runpy.run_path("examples/pruned_mlp.py", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0


def test_trace_report_parses_chrome_trace(tmp_path):
    """trace_report summarizes a Chrome-trace JSON (the GPU's device
    tracks, top ops) and degrades to ok=false on a host-only trace."""
    import gzip
    import json

    from bench.trace_report import main as report_main

    d = tmp_path / "plugins" / "profile" / "2026_08_20"
    d.mkdir(parents=True)
    events = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "pid": 1, "tid": 2, "name": "thread_name",
         "args": {"name": "XLA Ops"}},
        {"ph": "X", "pid": 1, "tid": 2, "name": "blocksparse_spmm", "ts": 0,
         "dur": 100},
        {"ph": "X", "pid": 1, "tid": 2, "name": "copy.b", "ts": 120,
         "dur": 30},
    ]
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    out = tmp_path / "report.json"
    rc = report_main([str(tmp_path), "--out", str(out)])
    assert rc == 0
    rec = json.loads(out.read_text())
    assert rec["ok"] and rec["device_tracks"]
    track = rec["device_tracks"]["/device:GPU:0/XLA Ops"]
    assert track["busy_ms"] == pytest.approx(0.13)
    assert rec["top_ops"][0]["op"] == "blocksparse_spmm"
    # host-only trace -> ok=false with a reason
    import shutil

    shutil.rmtree(tmp_path / "plugins")
    d2 = tmp_path / "plugins" / "profile" / "x"
    d2.mkdir(parents=True)
    with gzip.open(d2 / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": [
            {"ph": "M", "pid": 9, "name": "process_name",
             "args": {"name": "python"}},
            {"ph": "X", "pid": 9, "tid": 1, "name": "host_op", "ts": 0,
             "dur": 5}]}, f)
    rc = report_main([str(tmp_path)])
    assert rc == 1


def test_example_distributed_serving(monkeypatch):
    """The distributed example must stay runnable: all four schedules on
    the virtual mesh with the default (xla) local."""
    import runpy
    import sys

    monkeypatch.setattr(sys, "argv", [
        "distributed_serving", "--devices", "4", "--m", "96", "--k", "160",
        "--width", "64"])
    try:
        runpy.run_path("examples/distributed_serving.py",
                       run_name="__main__")
    except SystemExit as e:
        assert e.code == 0


def test_summarize_incomplete_marker_spans_provenance_groups():
    """A sweep_incomplete marker carries no bCols/bDtype; it must flag
    the provenance-keyed groups of its (testcase, format) instead of
    forming a phantom ("", "") row."""
    from bench.summarize import summarize

    recs = [
        {"testcase": "d", "format": "csr", "bCols": 256, "bDtype": "f32",
         "kernelType": "1", "correct": "1", "kernelTimeMs": 1.0},
        {"testcase": "d", "format": "csr", "sweep_incomplete": "1",
         "child_rc": 2},
        {"testcase": "d", "format": "coo", "bCols": 256, "bDtype": "f32",
         "kernelType": "1", "correct": "1", "kernelTimeMs": 2.0},
    ]
    rows = summarize(recs)
    by_fmt = {(r["testcase"], r["format"], r["bCols"]): r for r in rows}
    assert len(rows) == 2  # no phantom ("", "") group
    assert by_fmt[("d", "csr", 256)]["incomplete"] == "yes"
    assert by_fmt[("d", "coo", 256)]["incomplete"] == ""
    # a marker whose group shipped no records still surfaces
    rows2 = summarize([{"testcase": "x", "format": "bsr",
                        "sweep_incomplete": "1", "child_rc": 2}])
    assert len(rows2) == 1 and rows2[0]["incomplete"] == "yes"


@pytest.mark.parametrize("intervals,busy", [
    ([(0, 10), (5, 15)], 15),            # overlap counted once
    ([(0, 10), (2, 4), (20, 30)], 20),   # nested, then disjoint
    ([(0, 5), (5, 10)], 10),             # touching
])
def test_trace_report_merges_overlapping_intervals(intervals, busy):
    from bench.trace_report import summarize, union_us

    assert union_us(intervals) == busy
    events = [{"ph": "M", "pid": 1, "name": "process_name",
               "args": {"name": "/device:GPU:0"}}]
    events += [{"ph": "X", "pid": 1, "tid": 1, "name": "op", "ts": s,
                "dur": e - s} for s, e in intervals]
    tracks, _ = summarize(events)
    t = tracks["/device:GPU:0"]
    span = max(e for _, e in intervals) - min(s for s, _ in intervals)
    assert t["busy_frac"] == pytest.approx(busy / span)


def test_sweep_formats_isolate_parent_stays_off_jax():
    """--isolate runs each (dir, format) group in a child process and the
    parent never imports JAX, so the child is the only process on the
    card."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import subprocess, sys\n"
            "calls = []\n"
            "class R: returncode = 0\n"
            "subprocess.run = lambda c, **k: calls.append(c) or R()\n"
            "from bench import sweep_formats\n"
            "rc = sweep_formats.main(['--isolate', '--data-root', 'data', "
            "'--dirs', 'small_32x32', '--formats', 'csr,coo'])\n"
            "print(rc, len(calls), 'jax' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=repo, timeout=300)
    assert res.stdout.split() == ["0", "2", "False"], res.stderr


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_gpu_entry_points_refuse_the_cpu(script):
    """The headline benchmark and the smoke run exit non-zero and print
    no result when JAX finds no GPU: nothing falls back to the CPU."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(repo, script)],
                         capture_output=True, text=True, env=env, cwd=repo,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout and '"metric"' not in res.stdout
