"""End-to-end example: a pruned transformer MLP block served with tpuspmm.

The reference frames SpMM as the pruned-LLM inference primitive
(reference/README.md:11-24); this example is that use end to end: a
2-layer MLP whose weight matrices are block-sparse (4×4 pruning
granularity), applied to a batch of activations

    h = gelu(x @ W1ᵀ);  y = h @ W2ᵀ

Each `x @ Wᵀ` is `(W @ xᵀ)ᵀ` — a sparse-times-dense SpMM — so the layer
runs through `tpuspmm.spmm` with the chosen method.  The defaults are the
Llama-2-7B MLP widths (hidden_size 4096, intermediate_size 11008) at 90%
block sparsity, batch 512, bf16 activations; weights are random from a
seed.  Each layer is gated against the float64 oracle of the values it
was served.  Run it:

    python examples/pruned_mlp.py                # one device (or CPU)
    python examples/pruned_mlp.py --sharded      # row-sharded over all devices
"""

from __future__ import annotations

import argparse
import os
import sys

# allow running as a plain script from anywhere: put the repo root on
# sys.path when tpuspmm is not installed
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np


def build_layer(d_out: int, d_in: int, block_sparsity: float, seed: int):
    from tpuspmm.formats import BSR

    return BSR.random_blocks(d_out, d_in, block_size=(4, 4),
                             block_density=1.0 - block_sparsity, seed=seed)


def mlp_layers(w1, w2, x, spmm):
    """The served MLP: returns (h, y), h = gelu(x W1ᵀ) in x's dtype.
    ``spmm(w, b)`` computes w @ b."""
    import jax
    import jax.numpy as jnp

    h = jax.nn.gelu(spmm(w1, jnp.asarray(x).T).T).astype(x.dtype)
    y = spmm(w2, h.T).T
    return h, y


def check_layers(w1, w2, x, h, y, rel_tol=1e-2, abs_tol=1e-3) -> dict:
    """Gate each layer against the float64 oracle of the values it was
    served: layer 1 on x, layer 2 on the served (dtype-rounded) h."""
    import jax

    from tpuspmm.ops import oracle
    from tpuspmm.utils.compare import allclose

    dtype = np.asarray(x).dtype
    x64 = np.asarray(x).astype(np.float64)
    # layer 1: the oracle product, through the same f32 gelu and the same
    # rounding to the serving dtype as the served h
    h_pre = np.asarray(oracle.spmm_scipy_oracle(w1, x64.T)).T
    ref_h = np.asarray(jax.nn.gelu(h_pre)).astype(dtype)
    # layer 2: the oracle product on the served h
    h64 = np.asarray(h).astype(np.float64)
    ref_y = np.asarray(oracle.spmm_scipy_oracle(w2, h64.T)).T
    return {"layer1": allclose(h64, ref_h.astype(np.float64), rel_tol,
                               abs_tol),
            "layer2": allclose(np.asarray(y), ref_y, rel_tol, abs_tol)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--d-model", type=int, default=4096)
    p.add_argument("--d-ff", type=int, default=11008)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--block-sparsity", type=float, default=0.9)
    p.add_argument("--sharded", action="store_true")
    p.add_argument("--method", default="tuned",
                   choices=["auto", "xla", "pallas", "tuned", "vendor",
                            "densify"])
    p.add_argument("--activations-dtype", default="bf16",
                   choices=["f32", "bf16"],
                   help="bf16 = how activations arrive in LLM serving; "
                        "kernels ingest them directly, outputs stay f32")
    args = p.parse_args(argv)

    import jax

    import tpuspmm
    from tpuspmm.config import describe_device, enable_compile_cache

    enable_compile_cache()
    rng = np.random.default_rng(0)
    w1 = build_layer(args.d_ff, args.d_model, args.block_sparsity, seed=1)
    w2 = build_layer(args.d_model, args.d_ff, args.block_sparsity, seed=2)
    x = rng.standard_normal((args.batch, args.d_model)).astype(np.float32) * 0.1
    if args.activations_dtype == "bf16":
        import ml_dtypes

        x = x.astype(ml_dtypes.bfloat16)
    print(f"# W1 {w1.shape} ({w1.nnz} nnz), W2 {w2.shape}, "
          f"x {x.shape}, {describe_device()}", file=sys.stderr)

    if args.sharded:
        from tpuspmm.parallel import make_mesh, spmm_row_sharded

        mesh = make_mesh((len(jax.devices()),), ("rows",))
        spmm = lambda w, b: spmm_row_sharded(w, b, mesh, local="xla")
    else:
        spmm = lambda w, b: tpuspmm.spmm(w, b, method=args.method)

    t0 = time.perf_counter()
    h, y = jax.block_until_ready(mlp_layers(w1, w2, x, spmm))
    t1 = time.perf_counter()
    ok = check_layers(w1, w2, x, h, y)
    print(f"# first call (incl. plans, tuning, compile): {t1 - t0:.2f}s, "
          f"output {y.shape}, layers match the f64 oracle: {ok}",
          file=sys.stderr)
    print({"correct": all(ok.values()), "layers": ok,
           "out_shape": list(y.shape), "sharded": args.sharded,
           "method": args.method,
           "activations_dtype": args.activations_dtype})
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
