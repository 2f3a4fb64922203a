"""Pruned-LLM BSR benchmark: block-sparse weight × dense activation.

BASELINE.json config 4: weight matrices with 80-95% block sparsity at 4×4
block granularity (magnitude-pruned transformer weights), dense operand
width 512.  Times and gates every variant of the BSR engine (block
einsum, densify + cuBLAS, the Triton block-sparse kernel, compensated
f32) and the cuSPARSE baseline.

Usage::

    python -m bench.pruned_llm [--dim 4096] [--width 512]
        [--block-sparsity 0.8,0.9,0.95] [--repeats 12]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dim", type=int, default=4096)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--block-sparsity", default="0.8,0.9,0.95")
    p.add_argument("--block", type=int, default=4)
    p.add_argument("--repeats", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--b-dtype", default="f32", choices=["f32", "bf16"],
                   help="activation ingestion dtype — bf16 is how "
                        "activations actually arrive in LLM serving; "
                        "the gate then checks vs the f64 oracle OF THE "
                        "bf16 VALUES (see tpuspmm.cli --b-dtype)")
    args = p.parse_args(argv)

    import jax.numpy as jnp

    from tpuspmm.formats import BSR
    from tpuspmm.engine.registry import get_engine
    from tpuspmm.config import default_config
    from tpuspmm.ops import oracle
    from tpuspmm.utils.compare import allclose
    from tpuspmm.config import describe_device, enable_compile_cache
    from tpuspmm.ops import vendor
    from tpuspmm.utils.timing import time_ms

    enable_compile_cache()
    config = default_config()
    engine = get_engine("bsr")
    rng = np.random.default_rng(args.seed)
    b = rng.standard_normal((args.dim, args.width)).astype(np.float32) * 0.05
    if args.b_dtype == "bf16":
        import ml_dtypes

        # the oracle sees the bf16 values (upcast): the gate checks the
        # numerics of the operand actually served, not a different input
        b = b.astype(ml_dtypes.bfloat16)
    b_dev = jnp.asarray(b)
    dev = describe_device()
    print(f"# {dev}", file=sys.stderr)

    all_results = []
    for bs in (float(x) for x in args.block_sparsity.split(",")):
        a = BSR.random_blocks(
            args.dim, args.dim, block_size=(args.block, args.block),
            block_density=1.0 - bs, seed=args.seed,
        )
        ref = oracle.spmm_oracle(a, b)
        flops = 2.0 * a.nnz * args.width
        print(f"# sparsity {bs:.0%}: {a.nblocks} blocks, nnz={a.nnz}",
              file=sys.stderr)
        routes = [(v.name, lambda v=v: v.fn(a, b_dev, config))
                  for v in engine.variants
                  if not v.inadmissible_reason(a, b_dev, config)]
        routes.append(("vendor_cusparse",
                       lambda: vendor.spmm_vendor(a, b_dev)))
        for name, fn in routes:
            ms, out = time_ms(fn, repeats=args.repeats)
            ok = allclose(np.asarray(out), ref, 1e-2, 1e-3)
            gflops = flops / (ms / 1e3) / 1e9
            print(f"#   {name:24s} {ms:8.4f} ms  {gflops:8.1f} GFLOP/s"
                  f"  correct={ok}", file=sys.stderr)
            all_results.append({"block_sparsity": bs, "variant": name,
                                "ms": ms, "gflops": gflops,
                                "correct": bool(ok)})

    print(json.dumps({"dim": args.dim, "width": args.width,
                      "block": args.block, "bDtype": args.b_dtype,
                      "device": dev, "results": all_results}))
    return 0 if all(r["correct"] for r in all_results) else 1


if __name__ == "__main__":
    sys.exit(main())
