"""Smoke run of the SpMM main path on one GPU, through the user entry points.

    python chip_smoke.py               # one GPU: phases 1-6
    python chip_smoke.py --multichip   # four GPUs: the mesh schedules only
    python chip_smoke.py --cpu-rehearsal [--multichip]
                                       # the same control flow on virtual
                                       # CPU devices at small sizes, Pallas
                                       # interpreted; prints no result

Phases (one process, one line each; any failure makes the exit code 1):

1. device — JAX platform and device_kind, the card's nvidia-smi name and
   power limit; anything but a GPU fails.
2. cli — ``tpuspmm.cli --csr --coo --bsr --ell -d data/large_25605
   --width 256`` and ``--auto -d data/large_21074``: every record that
   ran is correct, none was interpreted, the vendor record lowered to
   cuSPARSE.
3. headline — ``bench.py``: ``method="tuned"`` serving on large_25605 at
   width 256, f32 and bf16 B, gated.
4. pruned_llm — ``examples/pruned_mlp.py``'s layer code at Llama-2-7B MLP
   widths (4096 → 11008 → 4096), 90% 4×4-block sparsity, batch 512, bf16
   activations, ``method="tuned"``; each layer gated against the float64
   oracle.
5. kernel — the Triton block-sparse kernel against the oracle and
   against XLA's plain version of the same plan, at large_25605 width
   256 (f32, bf16 B) and the Llama-2-7B-shaped weight at width 512.
6. gpu_tests — ``pytest -m gpu`` in this process.

``--multichip``: large_25605 stacked 4× by rows, width 256, through
spmm_row_sharded, spmm_2d (2×2), spmm_ring and spmm_kshard with each
local compute, plus one lsq_train_step; each compared with the float64
oracle.

The last line of a GPU run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 1e-2, 1e-3

_failures = []


def phase(name):
    """Run one phase: print one line, remember a failure."""
    def wrap(fn):
        t0 = time.perf_counter()
        try:
            detail = fn()
            ok = True
        except Exception as e:  # a phase that raises fails; the run goes on
            detail = f"{type(e).__name__}: {e}"
            traceback.print_exc(file=sys.stderr)
            ok = False
        if not ok:
            _failures.append(name)
        print(f"phase {name}: {'ok' if ok else 'FAIL'} "
              f"({time.perf_counter() - t0:.1f} s) {detail}", flush=True)
        return fn
    return wrap


def _records(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def load_script(name, path):
    """Import a script of the checkout that is not a package module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cli(argv):
    from tpuspmm import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, _records(buf.getvalue())


def check_cli_records(recs, gpu: bool):
    ran = [r for r in recs if r.get("skipped") != "inadmissible"]
    bad = [r for r in ran if r.get("correct") != "1"]
    assert ran and not bad, f"incorrect or errored records: {bad}"
    if gpu:
        interp = [r for r in recs if r.get("interpreted") == "1"]
        assert not interp, f"interpreted records: {interp}"
        vend = [r for r in recs if r["kernelType"] == "-1"]
        assert vend and all(r["vendorLowering"].startswith("cusparse")
                            for r in vend), vend
    return (f"{len(ran)} records correct, "
            f"{len(recs) - len(ran)} inadmissible")


def single_device(gpu: bool):
    """Phases 2-6."""
    data = lambda name: os.path.join(REPO, "data", name)
    big = data("large_25605") if gpu else data("small_32x32")
    auto = data("large_21074") if gpu else data("medium_1484")

    @phase("cli")
    def _():
        rc, recs = run_cli(["--csr", "--coo", "--bsr", "--ell", "-d", big,
                            "--width", "256"])
        rc2, recs2 = run_cli(["--auto", "-d", auto, "--width", "256"])
        assert rc == 0 and rc2 == 0, (rc, rc2)
        vendor = sorted({r.get("vendorLowering") for r in recs + recs2
                         if r["kernelType"] == "-1"})
        return check_cli_records(recs + recs2, gpu) + f", vendor {vendor}"

    @phase("headline")
    def _():
        if not gpu:
            return "skipped: bench.py needs a GPU"
        headline = load_script("bench_headline", "bench.py")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = headline.main([])
        rec = _records(buf.getvalue())[-1]
        assert rc == 0 and rec["correct"] and rec["bf16_serving_correct"], rec
        return (f"{rec['kernel']} {rec['kernel_ms']:.4f} ms f32, "
                f"{rec['bf16_serving_ms']:.4f} ms bf16, vendor "
                f"{rec['vendor_ms']:.4f} ms ({rec['vendor_lowering']})")

    @phase("pruned_llm")
    def _():
        import jax
        import ml_dtypes
        import numpy as np

        import tpuspmm

        mlp = load_script("pruned_mlp", os.path.join("examples",
                                                     "pruned_mlp.py"))
        d_model, d_ff, batch = (4096, 11008, 512) if gpu else (64, 176, 32)
        w1 = mlp.build_layer(d_ff, d_model, 0.9, seed=1)
        w2 = mlp.build_layer(d_model, d_ff, 0.9, seed=2)
        x = (np.random.default_rng(0).standard_normal((batch, d_model))
             * 0.1).astype(ml_dtypes.bfloat16)
        spmm = lambda w, b: tpuspmm.spmm(w, b, method="tuned")
        h, y = jax.block_until_ready(mlp.mlp_layers(w1, w2, x, spmm))
        ok = mlp.check_layers(w1, w2, x, h, y)
        assert all(ok.values()), ok
        winners = [getattr(w, "_tune_cache", {}) for w in (w1, w2)]
        served = [next(iter(c.values()))[0].variant_name if c else "?"
                  for c in winners]
        return (f"W1 {w1.shape} W2 {w2.shape} x {x.shape} bf16, layers "
                f"{ok}, served {served}")

    @phase("kernel")
    def _():
        import ml_dtypes
        import numpy as np

        from bench import kernel_compare as kc
        from tpuspmm.formats import convert

        a = convert.load_sparse(big, "csr")
        rng = np.random.default_rng(0)
        b = rng.standard_normal((a.shape[1], 256)).astype(np.float32)
        cases = [("large_f32", a, b), ("large_bf16", a,
                                       b.astype(ml_dtypes.bfloat16))]
        if gpu:
            w = kc.llama_mlp_weight()
            x = (rng.standard_normal((w.shape[1], 512)) * 0.1)
            cases += [("llama_bf16", w, x.astype(ml_dtypes.bfloat16)),
                      ("llama_f32", w, x.astype(np.float32))]
        parts = []
        for name, m, bb in cases:
            with contextlib.redirect_stdout(io.StringIO()):
                recs = kc.measure_case(name, m, bb, ("triton",
                                                     "xla_blockplan"),
                                       repeats=10)
            assert all(r["correct"] for r in recs), recs
            t = {r["route"]: r["ms"] for r in recs}
            parts.append(f"{name} triton {t['triton']:.4f} ms vs xla "
                         f"{t['xla_blockplan']:.4f} ms")
        return (f"gate rel {RTOL} abs {ATOL} vs f64 oracle; dots bf16x"
                f"{{1,3,6}} split, f32 accumulate; " + "; ".join(parts))

    @phase("gpu_tests")
    def _():
        if not gpu:
            return "skipped: the gpu tests need a GPU"
        import pytest

        os.environ["TPUSPMM_TEST_GPU"] = "1"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = pytest.main([os.path.join(REPO, "tests"), "-m", "gpu", "-q",
                              "-p", "no:cacheprovider", "-p", "no:xdist"])
        tail = buf.getvalue().strip().splitlines()[-1:]
        assert rc == 0, buf.getvalue()[-3000:]
        return tail[0] if tail else ""


def multichip(n_dev: int, interpret):
    """The mesh schedules × local computes and one training step."""
    import jax
    import numpy as np
    import scipy.sparse

    from tpuspmm.formats import CSR, convert
    from tpuspmm.parallel import (lsq_train_step, make_mesh,
                                  make_train_state, spmm_2d, spmm_kshard,
                                  spmm_ring, spmm_row_sharded)
    from tpuspmm.parallel.spmm import LOCALS
    from tpuspmm.utils.compare import allclose

    name = "large_25605" if interpret is None else "medium_1484"
    base = convert.load_sparse(os.path.join(REPO, "data", name), "csr")
    a = CSR.from_scipy(scipy.sparse.vstack([base.to_scipy()] * n_dev).tocsr())
    b = np.random.default_rng(0).standard_normal(
        (a.shape[1], 256)).astype(np.float32)
    ref = a.to_scipy().astype(np.float64) @ b.astype(np.float64)
    mesh1 = make_mesh((n_dev,), ("rows",))
    mesh2 = make_mesh((2, n_dev // 2), ("rows", "cols"))

    schedules = {
        "row_sharded": lambda loc: spmm_row_sharded(a, b, mesh1, local=loc,
                                                    interpret=interpret),
        "2d": lambda loc: spmm_2d(a, b, mesh2, local=loc,
                                  interpret=interpret),
        "ring": lambda loc: spmm_ring(a, b, mesh1, local=loc,
                                      interpret=interpret),
        "kshard": lambda loc: spmm_kshard(a, b, mesh1, local=loc,
                                          interpret=interpret),
    }
    for sched, fn in schedules.items():
        for loc in LOCALS:
            @phase(f"{sched}/{loc}")
            def _():
                from tpuspmm.utils.timing import time_ms

                ms, out = time_ms(lambda: fn(loc), repeats=5)
                assert allclose(np.asarray(out), ref, RTOL, ATOL)
                return (f"A {a.shape} nnz {a.nnz}, B {b.shape}: "
                        f"{ms:.4f} ms, matches the f64 oracle")

    @phase("lsq_train_step")
    def _():
        lr = 1e-3
        state = make_train_state(a, 256, mesh2, seed=0)
        b0 = np.asarray(state["b"], np.float64)
        c = np.asarray(state["c_target"], np.float64)
        new, loss = lsq_train_step(state, mesh2, lr=lr)
        a_pad = a.to_scipy().astype(np.float64)
        a_pad.resize((c.shape[0], b0.shape[0]))
        res = a_pad @ b0 - c
        ref_loss = 0.5 * float(np.sum(res * res))
        ref_b = b0 - lr * (a_pad.T @ res)
        assert allclose(np.asarray(new["b"]), ref_b, RTOL, ATOL)
        assert abs(float(loss) - ref_loss) <= RTOL * abs(ref_loss)
        return (f"mesh 2x{n_dev // 2}, loss {float(loss):.6e} vs f64 "
                f"{ref_loss:.6e}, updated B matches the f64 oracle")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multichip", action="store_true",
                   help="run only the four-device mesh path")
    p.add_argument("--cpu-rehearsal", action="store_true",
                   help="virtual CPU devices, small inputs, Pallas "
                        "interpreted; prints no result line")
    args = p.parse_args(argv)
    n_dev = 4 if args.multichip else 1

    import jax

    if args.cpu_rehearsal:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", n_dev)
        os.environ["TPUSPMM_INTERPRET"] = "1"
    devs = jax.devices()
    gpu = devs[0].platform == "gpu"
    if not gpu and not args.cpu_rehearsal:
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devs[0].platform}); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tpuspmm.config import card_name_and_power, enable_compile_cache

    enable_compile_cache(REPO)
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}

    @phase("device")
    def _():
        assert len(devs) >= n_dev, f"{len(devs)} devices, need {n_dev}"
        return f"{device}"

    # the card's name and power limit, exactly as nvidia-smi prints them
    print(card_name_and_power() or "nvidia-smi: not available", flush=True)
    if args.multichip:
        multichip(n_dev, None if gpu else True)
    else:
        single_device(gpu)
    if _failures:
        print(f"chip_smoke: failed phases {_failures}", file=sys.stderr)
        return 1
    if args.cpu_rehearsal:
        print("chip_smoke: CPU rehearsal passed (no result: not a GPU run)",
              file=sys.stderr)
        return 0
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
