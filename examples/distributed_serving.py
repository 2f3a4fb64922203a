"""Example: one SpMM, four mesh schedules — pick by what fits where.

The reference is strictly single-GPU (hard-coded device pin,
reference/src/main.cu:176); tpuspmm's distributed layer is the
new-build capability on top.  This example serves the same C = A @ B
through every schedule on an n-device mesh and prints what each one
communicates:

- ``row``    — A row-sharded, B replicated: zero collectives; the
               weak-scaling workhorse when B fits every device.
- ``2d``     — A row-sharded, B column-sharded: still collective-free,
               per-device memory drops by the mesh area.
- ``ring``   — B K-sharded, panels ppermuted around the ring while
               each device multiplies the bucket matching the panel it
               holds: no device ever stores all of B, communication
               ((n-1)/n of B) overlapped with compute.
- ``kshard`` — A column-sharded, full-height partials psum_scattered:
               one reduce-scatter of C, complementary to the ring.

Every schedule serves either local compute: ``xla`` (gather +
segment-sum, the default) or ``blocksparse`` (the Triton kernel; on a
GPU, or interpreted with ``--interpret``).

Run on the host's GPUs, or on virtual CPU devices::

    python examples/distributed_serving.py [--devices 4] [--local xla]
"""

from __future__ import annotations

import argparse
import os
import sys

# allow running as a plain script from anywhere: put the repo root on
# sys.path when tpuspmm is not installed
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, default=4)
    p.add_argument("--m", type=int, default=512)
    p.add_argument("--k", type=int, default=1024)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--density", type=float, default=0.05)
    p.add_argument("--local", default="xla", choices=["xla", "blocksparse"])
    p.add_argument("--interpret", action="store_true",
                   help="run the blocksparse local interpreted (no GPU)")
    args = p.parse_args(argv)

    import jax

    from tpuspmm.config import enable_compile_cache

    enable_compile_cache()
    if len(jax.devices()) < args.devices:
        print(f"note: {len(jax.devices())} devices visible; set "
              "jax_num_cpu_devices before backend init (tests/conftest.py "
              "does) for a larger virtual mesh", file=sys.stderr)
        args.devices = len(jax.devices())

    from tpuspmm.formats import CSR
    from tpuspmm.ops import oracle
    from tpuspmm.parallel import (
        make_mesh, spmm_row_sharded, spmm_2d, spmm_ring, spmm_kshard)
    from tpuspmm.utils.compare import allclose

    n = args.devices
    a = CSR.random(args.m, args.k, args.density, seed=3)
    b = np.random.default_rng(0).standard_normal(
        (args.k, args.width)).astype(np.float32)
    ref = oracle.spmm_oracle(a, b)
    b_mb = b.nbytes / 1e6

    mesh1d = make_mesh((n,), ("rows",))
    rows_dim, cols_dim = (n // 2, 2) if n % 2 == 0 and n >= 4 else (n, 1)
    mesh2d = make_mesh((rows_dim, cols_dim))

    interp = True if args.interpret else None
    runs = [
        ("row", f"B replicated ({b_mb:.1f} MB/device), no collectives",
         lambda: spmm_row_sharded(a, b, mesh1d, local=args.local,
                                  interpret=interp)),
        ("2d", f"B column-sharded ({b_mb / cols_dim:.1f} MB/device), "
               "no collectives",
         lambda: spmm_2d(a, b, mesh2d, local=args.local,
                         interpret=interp)),
        ("ring", f"B K-sharded ({b_mb / n:.1f} MB/device), "
                 f"{(n - 1) / n * b_mb:.1f} MB ppermuted per device, "
                 "overlapped",
         lambda: spmm_ring(a, b, mesh1d, local=args.local,
                           interpret=interp)),
        ("kshard", f"A K-sharded, one psum_scatter of C "
                   f"({ref.nbytes / 1e6:.1f} MB reduced)",
         lambda: spmm_kshard(a, b, mesh1d, local=args.local,
                             interpret=interp)),
    ]
    ok = True
    for name, note, fn in runs:
        out = np.asarray(fn())
        good = allclose(out, ref, 1e-2, 1e-3)
        ok &= good
        print(f"{name:7s} local={args.local:11s} correct={good}   {note}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
