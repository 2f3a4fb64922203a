"""tpuspmm command-line driver.

Counterpart of the reference CLI (reference/src/main.cu:19-217): per-format
flags, a data-directory argument with the same file-discovery contract
(main.cu:98-144), and one JSON record per run on stdout.  Additions over the
reference: direct `.mtx` loading (no offline conversion required), `--auto`
format selection, `--width` to synthesise a dense operand when the data dir
lacks one (the reference's missing-blob dirs), and `--out` to append records
to a file like the test sweeps do via shell redirection
(reference/test/csr.sh:3-14).

Usage::

    python -m tpuspmm.cli --csr --coo -d data/small_32x32
    python -m tpuspmm.cli --auto -d data/large_25605 --width 256
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpuspmm",
        description="SpMM benchmark/verification driver (reference: cuspmm --csr --coo --bsr --ell -d DIR)",
    )
    p.add_argument("--csr", action="store_true", help="run the CSR engine")
    p.add_argument("--coo", action="store_true", help="run the COO engine")
    p.add_argument("--bsr", action="store_true", help="run the BSR engine")
    p.add_argument("--ell", action="store_true", help="run the ELL engine")
    p.add_argument("--auto", action="store_true", help="format-selection engine picks the format")
    p.add_argument("-d", "--data-dir", required=True, help="data directory (reference layout)")
    p.add_argument("--width", type=int, default=None, help="dense-operand width when synthesising B")
    p.add_argument("--synth-b", action="store_true",
                   help="ignore on-disk dense operands; synthesise B of "
                        "--width (same contract as bench.sweep_formats)")
    p.add_argument("--b-dtype", default="f32", choices=["f32", "bf16"],
                   help="dense-operand ingestion dtype: bf16 is the "
                        "pruned-LLM serving mode; the gate checks every "
                        "variant against the f64 oracle OF THE bf16 "
                        "OPERAND, records carry bDtype=bf16")
    p.add_argument("--skip-seq", action="store_true", help="skip the sequential oracle (verify vs scipy)")
    p.add_argument("--no-vendor", action="store_true", help="skip the cuSPARSE baseline (kernel -1)")
    p.add_argument("--repeats", type=int, default=3, help="steady-state timing repeats")
    p.add_argument("--kernel", type=int, default=None, help="run only this kernel number (-1/0/1..N)")
    p.add_argument("--tuned", action="store_true",
                   help="autotune: verify+time every admissible variant, serve "
                        "the winner, emit one record with the ranking")
    p.add_argument("--out", type=str, default=None, help="append JSON records to this file")
    p.add_argument("--interpret", action="store_true", help="run Pallas kernels interpreted (no GPU needed)")
    p.add_argument("--trace", type=str, default=None,
                   help="write a jax.profiler trace to this directory")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from tpuspmm.config import default_config, enable_compile_cache
    from tpuspmm.formats import convert
    from tpuspmm.engine.registry import get_engine
    from tpuspmm.engine.runner import run_engine
    from tpuspmm.engine import report as report_mod

    enable_compile_cache()
    config = default_config()
    if args.interpret:
        config.interpret = True

    if not os.path.isdir(args.data_dir):
        # bare corpus names resolve through the data search path
        # (tpuspmm/data.py)
        from tpuspmm.data import data_dir as resolve_dir

        resolved = resolve_dir(args.data_dir)
        if resolved is None:
            # mirror the reference's explicit missing-path diagnostics
            # (reference/src/main.cu:146-174 exit(EXIT_FAILURE) paths)
            print(f"data directory {args.data_dir!r} does not exist", file=sys.stderr)
            return 2
        args.data_dir = resolved

    fmts = [f for f, on in (("csr", args.csr), ("coo", args.coo), ("bsr", args.bsr), ("ell", args.ell)) if on]
    if args.auto:
        from tpuspmm.engine.select import select_format

        probe = convert.load_sparse(args.data_dir, "coo")
        fmt, kernel = select_format(probe)
        print(f"# auto-selected format={fmt} kernel={kernel}", file=sys.stderr)
        fmts = [fmt]
    if not fmts:
        print("no format requested (--csr/--coo/--bsr/--ell/--auto)", file=sys.stderr)
        return 2

    testcase = os.path.basename(os.path.normpath(args.data_dir))
    dense = convert.load_dense(args.data_dir, width=args.width,
                               force_synthetic=args.synth_b)
    b = np.asarray(dense.data, dtype=np.float32)
    if args.b_dtype == "bf16":
        import ml_dtypes

        b = b.astype(ml_dtypes.bfloat16)  # run_engine serves it as-is

    def _provenance(rec):
        # operand provenance in every emitted record
        rec.setdefault("bDtype", args.b_dtype)
        rec["bSource"] = getattr(dense, "b_source", "ondisk")
        if args.width is not None:
            rec["widthArg"] = args.width
        return rec

    out_stream = open(args.out, "a") if args.out else None
    status = 0
    import contextlib

    from tpuspmm.utils.profiling import trace as profiler_trace

    trace_ctx = profiler_trace(args.trace) if args.trace else contextlib.nullcontext()
    try:
      with trace_ctx:
        for fmt in fmts:
            a = convert.load_sparse(args.data_dir, fmt)
            engine = get_engine(fmt)
            if args.tuned:
                from tpuspmm.engine import autotune
                from tpuspmm.utils.compare import allclose
                from tpuspmm.ops import oracle as oracle_mod

                ranking = autotune.tune(a, b, repeats=max(4, args.repeats),
                                        config=config, verbose=True)
                if not ranking:
                    print(f"# {fmt}: no variant passed tuning", file=sys.stderr)
                    status = 1
                    continue
                win = ranking[0]
                # run_kernel owns the full numbering incl. -1 = vendor
                result = np.asarray(engine.run_kernel(win.number, a, b,
                                                      config))
                ok = allclose(result, oracle_mod.spmm_scipy_oracle(a, b),
                              config.rel_tol, config.abs_tol)
                rec = report_mod.make_record(
                    testcase=testcase, sparsity=a.sparsity, fmt=fmt,
                    kernel_type=win.number, kernel_name=win.variant_name,
                    correct=ok, nnz=a.nnz, shape=a.shape, n=b.shape[1],
                    kernel_ms=win.ms,
                    extra={"tuned": "1", "ranking": [
                        {"kernel": r.variant_name, "ms": r.ms} for r in ranking]},
                )
                report_mod.emit(_provenance(rec), out_stream or sys.stdout)
                if not ok:
                    status = 1
                continue
            if args.kernel is not None:
                import time as _time

                import jax as _jax

                from tpuspmm.utils.compare import allclose
                from tpuspmm.utils.timing import time_ms
                from tpuspmm.ops import oracle as oracle_mod

                import jax.numpy as _jnp

                # B on the device once: the timed calls serve, they do not
                # re-transfer the operand (the oracle, kernel 0, stays host)
                b_in = b if args.kernel == 0 else _jnp.asarray(b)
                run = lambda: engine.run_kernel(args.kernel, a, b_in, config)
                t0 = _time.perf_counter()
                _jax.block_until_ready(run())
                first_ms = (_time.perf_counter() - t0) * 1e3
                kernel_ms, result = time_ms(run, warmup=0,
                                            repeats=max(1, args.repeats))
                ref = oracle_mod.spmm_scipy_oracle(a, b)
                ok = allclose(np.asarray(result), ref, config.rel_tol, config.abs_tol)
                if args.kernel > 0:
                    kname = engine.variant(args.kernel).name
                else:
                    kname = {0: "oracle_numpy_f64",
                             -1: "vendor_cusparse"}.get(args.kernel, "")
                rec = report_mod.make_record(
                    testcase=testcase, sparsity=a.sparsity, fmt=fmt,
                    kernel_type=args.kernel, kernel_name=kname,
                    correct=ok, nnz=a.nnz, shape=a.shape,
                    n=b.shape[1], prolog_ms=max(0.0, first_ms - kernel_ms),
                    kernel_ms=kernel_ms,
                )
                report_mod.emit(_provenance(rec), out_stream or sys.stdout)
                if not ok:
                    status = 1
                continue
            # emit=False always: provenance must be applied BEFORE the
            # records reach stdout too, not only the --out stream
            records = run_engine(
                engine, a, b, testcase=testcase, config=config,
                skip_seq=args.skip_seq, run_vendor=not args.no_vendor,
                repeats=args.repeats, emit=False,
            )
            for rec in records:
                report_mod.emit(_provenance(rec), out_stream or sys.stdout)
            if any(rec.get("correct") == "0" or "error" in rec
                   for rec in records):
                status = 1
    finally:
        if out_stream:
            out_stream.close()
    return status


if __name__ == "__main__":
    sys.exit(main())
