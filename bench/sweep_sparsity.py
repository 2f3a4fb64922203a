"""Synthetic density sweep: CSR + COO engines at densities 0.1-0.9.

Counterpart of reference/test/sparsity.sh:3-21 (which runs the binary over
the sp_<d>_2048x2048 dirs produced by gen_sparse.py).  Matrices are
generated in-process — no intermediate text files needed — with the same
recipe (2048², values U(−100,100), B width 1024,
reference/utils/python_utils/gen_sparse.py:63-84).

Usage::

    python -m bench.sweep_sparsity [--rows 2048] [--width 1024]
        [--densities 0.1,...,0.9] [--formats csr,coo] [--out chiprun_out/sparsity.jsonl]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rows", type=int, default=2048)
    p.add_argument("--cols", type=int, default=2048)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--densities", default="0.1,0.2,0.3,0.4,0.5,0.6,0.7,0.8,0.9")
    p.add_argument("--formats", default="csr,coo")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--lo", type=float, default=-1.0,
                   help="value range; the reference recipe is ±100 "
                        "(gen_sparse.py), but at that scale f32 kernels "
                        "cannot meet the abs-1e-3 gate on cancelling outputs")
    p.add_argument("--hi", type=float, default=1.0)
    p.add_argument("--b-dtype", default="f32", choices=["f32", "bf16"],
                   help="dense-operand ingestion dtype (see tpuspmm.cli "
                        "--b-dtype); records carry bDtype=bf16")
    p.add_argument("--skip-seq", action="store_true")
    p.add_argument("--no-vendor", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--fresh", action="store_true",
                   help="truncate --out instead of appending (regenerate "
                        "the artifact in one generation)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from tpuspmm.config import default_config, enable_compile_cache
    from tpuspmm.engine.registry import get_engine
    from tpuspmm.engine.runner import run_engine
    from tpuspmm.engine import report as report_mod
    from tpuspmm.formats import CSR, convert

    enable_compile_cache()
    config = default_config()
    rng = np.random.default_rng(args.seed)
    b = rng.uniform(args.lo, args.hi, (args.cols, args.width)).astype(np.float32)
    if args.b_dtype == "bf16":
        import ml_dtypes

        b = b.astype(ml_dtypes.bfloat16)  # run_engine serves it as-is
    out_stream = (open(args.out, "w" if args.fresh else "a")
                  if args.out else sys.stdout)

    failures = 0
    try:
        for ds in args.densities.split(","):
            density = float(ds)
            base = CSR.random(args.rows, args.cols, density, seed=args.seed,
                              lo=args.lo, hi=args.hi)
            testcase = f"sp_{density:g}_{args.rows}x{args.cols}"
            for fmt in args.formats.split(","):
                a = base if fmt == "csr" else convert.to_format(base, fmt)
                print(f"# {testcase} {fmt}: nnz={a.nnz}", file=sys.stderr)
                records = run_engine(
                    get_engine(fmt), a, b, testcase=testcase, config=config,
                    skip_seq=args.skip_seq, run_vendor=not args.no_vendor,
                    repeats=args.repeats, emit=False,
                )
                for rec in records:
                    rec["bSource"] = "synth"  # synthetic by construction
                    rec["widthArg"] = args.width
                    report_mod.emit(rec, out_stream)
                    if rec.get("correct") == "0" or "error" in rec:
                        failures += 1
    finally:
        if args.out:
            out_stream.close()
    print(f"# sparsity sweep done, {failures} incorrect records", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
