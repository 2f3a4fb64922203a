"""Headline benchmark: CSR SpMM on large_25605 (B width 256) on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}

value        — served throughput in GFLOP/s (2·nnz·N / t) of the tuned
               winner among the custom variants
vs_baseline  — speedup over the vendor path (cuSPARSE, kernel −1)

Config comes from BASELINE.json: the large_25605 SuiteSparse matrix
(n4c6-b13, 6300×25605, 88200 nnz), dense operand width 256 (synthesised
from a seed — the reference's dense.mtx for this dir is a missing blob,
reference/.MISSING_LARGE_BLOBS).  Times are the one timer's medians
(tpuspmm.utils.timing: plan cached, serve timed to completion).  The same
serve is then run with a bf16-ingested B.  Diagnostics go to stderr.

Exits non-zero when JAX finds no GPU or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from tpuspmm.data import data_dir as _data_dir


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", default=_data_dir("large_25605"))
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--repeats", type=int, default=50)
    args = p.parse_args(argv)

    from tpuspmm.config import (default_config, describe_device,
                                enable_compile_cache)

    enable_compile_cache()
    dev = describe_device()
    if dev["platform"] != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev['platform']}",
              file=sys.stderr)
        return 1

    import jax.numpy as jnp
    import ml_dtypes

    from tpuspmm.engine import autotune
    from tpuspmm.engine.registry import get_engine
    from tpuspmm.engine.report import (peak_mem_bytes_per_s, spmm_flops,
                                       spmm_min_bytes)
    from tpuspmm.formats import convert
    from tpuspmm.ops import oracle, vendor
    from tpuspmm.utils.compare import allclose
    from tpuspmm.utils.timing import time_ms

    a = convert.load_sparse(args.data_dir, "csr")
    dense = convert.load_dense(args.data_dir, width=args.width)
    b = np.asarray(dense.data, dtype=np.float32)
    testcase = os.path.basename(os.path.normpath(args.data_dir))
    print(f"# {testcase}: A {a.shape} nnz={a.nnz}, B {b.shape}, {dev}",
          file=sys.stderr)

    # the tuned winner among the custom variants (the vendor entry
    # competes for serving but is the baseline here)
    b_dev = jnp.asarray(b)
    ranking = [r for r in autotune.tune(a, b_dev, repeats=args.repeats)
               if r.number != -1]
    if not ranking:
        print("# no custom variant passed tuning", file=sys.stderr)
        return 1
    winner = get_engine("csr").variant(ranking[0].number)
    serve = lambda bb: winner.fn(a, bb, default_config())
    print(f"# serving: {winner.name} "
          f"(ranking: {[(r.variant_name, round(r.ms, 4)) for r in ranking]})",
          file=sys.stderr)

    ms, out = time_ms(lambda: serve(b_dev), repeats=args.repeats)
    correct = bool(allclose(np.asarray(out), oracle.spmm_scipy_oracle(a, b),
                            1e-2, 1e-3))
    vendor_ms, vout = time_ms(lambda: vendor.spmm_vendor(a, b_dev),
                              repeats=args.repeats)
    vendor_ok = bool(allclose(np.asarray(vout),
                              oracle.spmm_scipy_oracle(a, b), 1e-2, 1e-3))

    b16 = b.astype(ml_dtypes.bfloat16)
    b16_dev = jnp.asarray(b16)
    bf16_ms, out16 = time_ms(lambda: serve(b16_dev), repeats=args.repeats)
    bf16_correct = bool(allclose(
        np.asarray(out16), oracle.spmm_scipy_oracle(a, b16.astype(np.float64)),
        1e-2, 1e-3))

    n = b.shape[1]
    secs = ms / 1e3
    gflops = spmm_flops(a.nnz, n) / secs / 1e9
    peak = peak_mem_bytes_per_s(dev["platform"], dev["kind"])
    roofline = spmm_min_bytes(a.nnz, a.shape[0], a.shape[1], n) / peak / secs
    print(f"# ours {ms:.4f} ms ({gflops:.2f} GFLOP/s, {roofline*100:.2f}% "
          f"of the memory roofline) | vendor {vendor_ms:.4f} ms "
          f"({vendor.last_lowering(a)}) | bf16 {bf16_ms:.4f} ms",
          file=sys.stderr)
    record = {
        "metric": f"csr_spmm_gflops_{testcase}_w{n}",
        "kernel": winner.name,
        "value": gflops,
        "unit": "GFLOP/s",
        "vs_baseline": vendor_ms / ms,
        "kernel_ms": ms,
        "vendor_ms": vendor_ms,
        "vendor_lowering": vendor.last_lowering(a),
        "mem_roofline_frac": roofline,
        "bf16_serving_ms": bf16_ms,
        "correct": correct,
        "vendor_correct": vendor_ok,
        "bf16_serving_correct": bf16_correct,
        "device": dev,
        "bCols": int(n),
        "bSource": getattr(dense, "b_source", "ondisk"),
    }
    print(json.dumps(record))
    return 0 if (correct and vendor_ok and bf16_correct) else 1


if __name__ == "__main__":
    sys.exit(main())
