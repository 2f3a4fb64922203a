"""Per-format benchmark sweep over the reference data corpus.

Counterpart of the reference sweep scripts (reference/test/{csr,coo,bsr}.sh:
run the binary over every data dir, append stdout records to a .json file).
Here one process sweeps all requested formats × datasets via the engine and
writes newline-delimited JSON, plus a stderr summary table.

Usage::

    python -m bench.sweep_formats --formats csr,coo,bsr,ell \
        --out chiprun_out/formats.jsonl [--data-root data] \
        [--width 256] [--dirs small_32x32,medium_2048] [--repeats 5]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# the corpus shipped with the checkout; resolved without importing the
# package, so an --isolate parent never loads JAX
DEFAULT_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def _isolated_main(args, dirs) -> int:
    """Parent loop for --isolate: one child process per (data dir,
    format), each appending to --out, so one group's device-memory
    exhaustion cannot take down the rest of the sweep.  The parent never
    imports JAX, so the child is the only process on the card."""
    import json
    import subprocess

    if args.out and args.fresh:
        open(args.out, "w").close()  # one generation — truncate up front
    rc_total = 0
    for dirname in dirs:
        for fmt in args.formats.split(","):
            tmp = (args.out + f".{dirname}.{fmt}.part") if args.out else None
            cmd = [sys.executable, "-m", "bench.sweep_formats",
                   "--data-root", args.data_root, "--dirs", dirname,
                   "--formats", fmt, "--repeats", str(args.repeats)]
            if args.width is not None:
                cmd += ["--width", str(args.width)]
            if args.synth_b:
                cmd.append("--synth-b")
            if args.b_dtype != "f32":
                cmd += ["--b-dtype", args.b_dtype]
            if args.skip_seq:
                cmd.append("--skip-seq")
            if args.no_vendor:
                cmd.append("--no-vendor")
            if tmp:
                # the child writes a per-group part file fresh, so a
                # crashed child's partial records never reach the artifact
                cmd += ["--out", tmp, "--fresh"]
            rc = subprocess.run(cmd).returncode
            if tmp and os.path.exists(tmp):
                with open(args.out, "a") as out_f, open(tmp) as part:
                    out_f.write(part.read())
                    if rc not in (0, 1):
                        # the child crashed: mark the group so no reader
                        # mistakes a truncated group for a complete one
                        out_f.write(json.dumps(
                            {"testcase": dirname, "format": fmt,
                             "sweep_incomplete": "1", "child_rc": rc}) + "\n")
                os.remove(tmp)
            rc_total |= rc
    return rc_total


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data-root", default=DEFAULT_ROOT)
    p.add_argument("--dirs", default=None,
                   help="comma-separated dir names (default: all in root)")
    p.add_argument("--formats", default="csr,coo,bsr,ell")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--synth-b", action="store_true",
                   help="ignore on-disk dense operands; synthesise B of --width")
    p.add_argument("--b-dtype", default="f32", choices=["f32", "bf16"],
                   help="dense-operand ingestion dtype (bf16 = the "
                        "pruned-LLM serving mode; records carry "
                        "bDtype=bf16 — see tpuspmm.cli --b-dtype)")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--skip-seq", action="store_true")
    p.add_argument("--no-vendor", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--fresh", action="store_true",
                   help="truncate --out instead of appending: regenerate "
                        "the artifact in one generation (an appended-to "
                        "JSONL accumulates stale duplicate groups from "
                        "older registries)")
    p.add_argument("--isolate", action="store_true",
                   help="run each (data dir, format) group in its own "
                        "subprocess, so a device-memory fault is contained "
                        "to its group; the parent never imports JAX")
    args = p.parse_args(argv)

    dirs = (args.dirs.split(",") if args.dirs
            else sorted(d for d in os.listdir(args.data_root)
                        if os.path.isdir(os.path.join(args.data_root, d))))
    formats = args.formats.split(",")

    if args.isolate:
        return _isolated_main(args, dirs)

    from tpuspmm.config import default_config
    from tpuspmm.engine.registry import get_engine
    from tpuspmm.engine.runner import run_engine
    from tpuspmm.engine import report as report_mod
    from tpuspmm.formats import convert

    config = default_config()
    out_stream = (open(args.out, "w" if args.fresh else "a")
                  if args.out else sys.stdout)

    failures = 0
    try:
        for dirname in dirs:
            data_dir = os.path.join(args.data_root, dirname)
            try:
                dense = convert.load_dense(data_dir, width=args.width,
                                           force_synthetic=args.synth_b)
            except FileNotFoundError as e:
                print(f"# skip {dirname}: {e}", file=sys.stderr)
                continue
            b = np.asarray(dense.data, dtype=np.float32)
            if args.b_dtype == "bf16":
                import ml_dtypes

                b = b.astype(ml_dtypes.bfloat16)  # run_engine serves as-is
            for fmt in formats:
                try:
                    a = convert.load_sparse(data_dir, fmt)
                except FileNotFoundError:
                    continue
                print(f"# {dirname} {fmt}: A {a.shape} nnz={a.nnz} N={b.shape[1]}",
                      file=sys.stderr)
                records = run_engine(
                    get_engine(fmt), a, b, testcase=dirname,
                    config=config, skip_seq=args.skip_seq,
                    run_vendor=not args.no_vendor,
                    repeats=args.repeats, emit=False,
                )
                for rec in records:
                    # operand provenance: bCols and bDtype come from
                    # make_record/run_engine; the sweep adds where B came
                    # from and what --width asked for
                    rec["bSource"] = getattr(dense, "b_source", "ondisk")
                    if args.width is not None:
                        rec["widthArg"] = args.width
                    report_mod.emit(rec, out_stream)
                    if rec.get("correct") == "0" or "error" in rec:
                        failures += 1
                del a, records
            # drop the dir's containers (device plan arrays are cached on
            # them) before the next dir, so plans do not accumulate in
            # device memory across a whole-corpus sweep
            del b, dense
            import gc

            gc.collect()
    finally:
        if args.out:
            out_stream.close()
    print(f"# sweep done, {failures} incorrect or errored records",
          file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
