"""Weak-scaling harness: nnz/s at 1..N devices, row-sharded SpMM.

New-build capability (BASELINE.json north star: ≥75% weak-scaling
efficiency): the base matrix is replicated k× along its rows per device —
problem size grows with the mesh, so perfect scaling keeps time constant
and efficiency(n) = t(1) / t(n).

Runs on the host's GPUs, or on virtual CPU devices with --platform cpu
(the same mechanism as the test suite) to rehearse the schedules.

Usage::

    python -m bench.weak_scaling [--platform cpu] [--devices 1,2,4]
        [--base-dir data/large_25605] [--width 256]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def replicate_rows(a, k: int):
    """Stack k row-copies of `a` (the weak-scaling problem generator)."""
    import scipy.sparse

    from tpuspmm.formats import CSR

    sp = a.to_scipy().tocsr()
    return CSR.from_scipy(scipy.sparse.vstack([sp] * k).tocsr())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--platform", default=None, choices=[None, "cpu"],
                   help="cpu → virtual multi-device mesh")
    p.add_argument("--devices", default="1,2,4")
    from tpuspmm.data import data_dir as _dd
    p.add_argument("--base-dir", default=_dd("large_25605"))
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--schedule", default="row_sharded", choices=["row_sharded", "ring"])
    p.add_argument("--local", default="xla", choices=["xla", "blocksparse"],
                   help="per-device compute of the schedule")
    args = p.parse_args(argv)

    counts = [int(x) for x in args.devices.split(",")]
    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", max(counts))

    import jax

    from tpuspmm.formats import convert
    from tpuspmm.parallel import make_mesh, spmm_row_sharded, spmm_ring
    from tpuspmm.config import describe_device, enable_compile_cache
    from tpuspmm.utils.timing import time_ms

    enable_compile_cache()
    dev = describe_device()
    counts = [c for c in counts if c <= dev["count"]]
    print(f"# {dev}", file=sys.stderr)

    base = convert.load_sparse(args.base_dir, "csr")
    b = np.asarray(convert.load_dense(args.base_dir, width=args.width).data,
                   dtype=np.float32)

    results = []
    t1 = None
    for n in counts:
        a = replicate_rows(base, n) if n > 1 else base
        mesh = make_mesh((n,), ("rows",))
        # plans are cached on the container, so the warm-up call absorbs
        # the one-time host partitioning
        schedule = spmm_ring if args.schedule == "ring" else spmm_row_sharded
        fn = lambda: schedule(a, b, mesh, local=args.local)
        ms, _ = time_ms(fn, warmup=1, repeats=args.repeats)
        nnz_per_s = a.nnz / (ms / 1e3)
        if t1 is None:
            t1 = ms
        eff = t1 / ms
        results.append({"devices": n, "nnz": a.nnz, "ms": ms,
                        "nnz_per_s": nnz_per_s, "efficiency": eff})
        print(f"# n={n}: {ms:.2f} ms, {nnz_per_s/1e6:.1f} Mnnz/s, "
              f"eff={eff*100:.1f}%", file=sys.stderr)

    print(json.dumps({"schedule": args.schedule, "local": args.local,
                      "width": args.width, "device": dev,
                      "scaling": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
