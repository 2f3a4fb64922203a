"""Block-sparse Triton kernel against the other routes, on one device.

For each case (matrix × width × B dtype) it times, with the one timer of
``tpuspmm.utils.timing`` (plan cached, serve timed), and gates against
the float64 oracle at rel 1e-2 / abs 1e-3:

- ``triton``            the block-sparse kernel (``--geometries``: also
                        plans of other tile shapes, built here);
- ``xla_blockplan``     XLA's plain version of the same plan (gathered B
                        tiles + batched product + segment-sum), its dots
                        at ``Precision.HIGHEST`` (true f32);
- ``densify``           the library's cached dense A times B (cuBLAS at
                        ``Precision.HIGHEST``);
- ``*_x3`` / ``*_x6``   the same two plain versions with their dots at
                        XLA's ``BF16_BF16_F32_X3`` / ``_X6`` presets: bf16
                        tensor-core products of split f32 operands, the
                        precision class of the kernel's own dots;
- ``cusparse``          the vendor path (kernel −1);
- ``xla_gather``        gather + segment-sum over the triplets (registry
                        variant 1), where its intermediate fits.

Every route also gets its device busy time per call, from a
``jax.profiler`` trace of as many calls as were timed (host-clock serve
times below ~0.3 ms are set by dispatch, not by the device).

Cases: ``data/large_25605`` at width 256, B in f32 and bf16; one
Llama-2-7B MLP weight (intermediate_size 11008 × hidden_size 4096) at
90% sparsity in 4×4 blocks (every 64×64 tile occupied) and in 64×64
blocks (90% of the tiles skipped), width 512, B bf16 and f32; a fill
sweep of the 4×4-block weight at block densities 2-20%; a uniform-random
4096² density sweep at width 256 (the dispatch thresholds), and its 10%
point at width 1024 and at the Llama shape.

    python -m bench.kernel_compare [--quick] [--geometries] [--out FILE]

Needs a GPU; exits non-zero without one or when any gated result is
wrong.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (bm, bk) tile shapes tried with --geometries; the kernel's own comes
# first
GEOMETRIES = ((64, 64), (32, 32), (64, 32), (128, 64))
# cap on the (n_tiles, bk, N) intermediate of the plain XLA version
XLA_PLAN_MAX_BYTES = 16 << 30
PLAIN_ROUTES = ("triton", "xla_blockplan", "xla_blockplan_x3",
                "xla_blockplan_x6", "densify", "densify_x3", "densify_x6",
                "cusparse")
SWEEP_ROUTES = ("triton", "densify", "cusparse", "xla_gather")


def _precision(route: str):
    if route.endswith("_x3"):
        return jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    if route.endswith("_x6"):
        return jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X6
    return jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("n_rb", "bm", "bk", "precision"))
def _blockplan_xla(rb, kt, tiles, b, *, n_rb, bm, bk, precision):
    from tpuspmm.kernels.common import cdiv

    k, n = b.shape
    b = b.astype(jnp.float32)
    nkt = cdiv(k, bk)
    b_tiles = jnp.pad(b, ((0, nkt * bk - k), (0, 0))).reshape(nkt, bk, n)
    prod = jnp.einsum("tmk,tkn->tmn",
                      tiles.reshape(-1, bm, bk).astype(jnp.float32),
                      b_tiles[kt], precision=precision,
                      preferred_element_type=jnp.float32)
    out = jax.ops.segment_sum(prod, rb, num_segments=n_rb)
    return out.reshape(n_rb * bm, n)


def spmm_blockplan_xla(plan, b, precision=None):
    """The plain XLA version of a block plan: gather every tile's B rows
    into a (n_tiles, bk, N) array, one batched product, segment-sum by
    row block."""
    _, rb, kt, tiles = plan.device_arrays()
    out = _blockplan_xla(rb, kt, tiles, jnp.asarray(b), n_rb=plan.n_row_blocks,
                         bm=plan.bm, bk=plan.bk,
                         precision=precision or jax.lax.Precision.HIGHEST)
    return out[:plan.shape[0]]


@functools.partial(jax.jit, static_argnames=("precision",))
def _dense_dot(a, b, *, precision):
    return jnp.dot(a, b.astype(jnp.float32), precision=precision,
                   preferred_element_type=jnp.float32)


def plan_of(a, bm: int, bk: int):
    """A block plan of any tile shape (the library builds only its own)."""
    from tpuspmm.kernels import blocksparse_gpu as bs
    from tpuspmm.ops.xla import coo_view

    if (bm, bk) == (bs.BM, bs.BK):
        return bs.block_plan(a)
    coo = coo_view(a)
    return bs.build_block_plan(np.asarray(coo.rows), np.asarray(coo.cols),
                               np.asarray(coo.values), coo.shape, bm, bk)


def llama_mlp_weight(sparsity: float = 0.9, block: int = 4, seed: int = 0):
    """Llama-2-7B up-projection shape (intermediate_size 11008 ×
    hidden_size 4096), pruned to ``sparsity`` at block × block
    granularity; random values from ``seed``."""
    from tpuspmm.formats import BSR

    return BSR.random_blocks(11008, 4096, block_size=(block, block),
                             block_density=1.0 - sparsity, seed=seed)


def _cases(quick: bool):
    """(name, A, B, routes) of every case."""
    import ml_dtypes
    import scipy.sparse as sp

    from tpuspmm.data import data_dir
    from tpuspmm.formats import CSR, convert

    bf16 = ml_dtypes.bfloat16
    rng = np.random.default_rng(0)
    a = convert.load_sparse(data_dir("large_25605"), "csr")
    b = rng.standard_normal((a.shape[1], 256)).astype(np.float32)
    large = ("triton", "xla_blockplan", "densify", "cusparse", "xla_gather")
    yield "large_25605_w256_f32", a, b, large
    yield "large_25605_w256_bf16", a, b.astype(bf16), large
    x = (rng.standard_normal((4096, 512)) * 0.1).astype(np.float32)
    for block in (4, 64):
        w = llama_mlp_weight(block=block)
        yield f"llama7b_up_bsr{block}_s90_w512_bf16", w, x.astype(bf16), \
            PLAIN_ROUTES
        yield f"llama7b_up_bsr{block}_s90_w512_f32", w, x, PLAIN_ROUTES
    if quick:
        return
    for s in (0.98, 0.95, 0.8):
        yield (f"llama7b_up_bsr4_s{round(s * 100)}_w512_bf16",
               llama_mlp_weight(sparsity=s), x.astype(bf16), SWEEP_ROUTES)
    uniform = lambda m, d: CSR.from_scipy(sp.random(
        m, 4096, density=d, random_state=1, format="csr", dtype=np.float32))
    for d in (0.001, 0.005, 0.02, 0.05, 0.1, 0.2):
        yield (f"uniform4096_d{d}_w256_f32", uniform(4096, d),
               rng.standard_normal((4096, 256)).astype(np.float32),
               SWEEP_ROUTES)
    # the 10% point at a wider B and at the Llama shape: the kernel's grid
    # (row blocks × column tiles) grows, the fill does not
    yield ("uniform4096_d0.1_w1024_f32", uniform(4096, 0.1),
           rng.standard_normal((4096, 1024)).astype(np.float32), SWEEP_ROUTES)
    u = uniform(11008, 0.1)
    yield "uniform11008x4096_d0.1_w512_bf16", u, x.astype(bf16), SWEEP_ROUTES


def device_ms_per_call(fn, calls: int):
    """Device busy time per call: the union of the device's compute-stream
    intervals in a profiler trace of ``calls`` calls, divided by
    ``calls``."""
    from bench.trace_report import _is_device, find_trace_json, load_events
    from bench.trace_report import summarize
    from tpuspmm.utils.profiling import trace

    log_dir = os.path.join(REPO, ".kc_trace")
    shutil.rmtree(log_dir, ignore_errors=True)
    jax.block_until_ready(fn())
    with trace(log_dir):
        for _ in range(calls):
            jax.block_until_ready(fn())
    path = find_trace_json(log_dir)
    if path is None:
        raise RuntimeError("the profiler wrote no trace")
    tracks, _ = summarize(load_events(path))
    shutil.rmtree(log_dir, ignore_errors=True)
    busy = [t["busy_ms"] for k, t in tracks.items()
            if _is_device(k) and "Memcpy" not in k]
    if not busy:
        raise RuntimeError("the trace holds no device compute track")
    return sum(busy) / calls


def measure_case(name, a, b, routes=PLAIN_ROUTES, repeats: int = 20,
                 geometries=GEOMETRIES[:1], device_time: bool = False):
    """Time and gate every route on (a, b); one dict per route/geometry."""
    from tpuspmm.engine.registry import GATHER_MAX_BYTES
    from tpuspmm.kernels import blocksparse_gpu as bs
    from tpuspmm.ops import oracle, vendor, xla
    from tpuspmm.ops.api import spmm
    from tpuspmm.utils.compare import allclose
    from tpuspmm.utils.timing import time_ms

    ref = oracle.spmm_scipy_oracle(a, np.asarray(b))
    b_dev = jnp.asarray(b)
    n = int(b.shape[1])
    out = []

    def run(route, fn, **extra):
        try:
            ms, c = time_ms(fn, warmup=1, repeats=repeats)
            ok = bool(allclose(np.asarray(c), ref, 1e-2, 1e-3))
            rec = {"case": name, "route": route, "ms": ms, "correct": ok,
                   **extra}
            if device_time:
                rec["device_ms"] = device_ms_per_call(fn, repeats)
        except Exception as e:  # recorded as an error, counted as a failure
            rec = {"case": name, "route": route, "error":
                   f"{type(e).__name__}: {str(e)[:300]}", "correct": False,
                   **extra}
        print(json.dumps(rec), flush=True)
        out.append(rec)

    plans = {g: plan_of(a, *g) for g in geometries}
    stats = bs.plan_stats(a)
    if "triton" in routes:
        for (bm, bk), plan in plans.items():
            run("triton", lambda: bs.spmm_blocksparse(plan, b_dev),
                bm=bm, bk=bk, tiles=plan.n_tiles,
                occupancy=round(plan.n_tiles / (plan.n_row_blocks
                                                * -(-a.shape[1] // bk)), 4),
                fill=round(plan.fill, 4),
                plan_mb=round(plan.plan_bytes / 1e6, 2),
                tile_dtype=str(plan.tiles.dtype))
            assert (bm, bk) != (bs.BM, bs.BK) or (
                stats.n_tiles == plan.n_tiles
                and stats.plan_bytes == plan.plan_bytes), (stats, plan)
    for route in routes:
        if route.startswith("xla_blockplan"):
            for (bm, bk), plan in plans.items():
                if plan.n_tiles * bk * n * 4 > XLA_PLAN_MAX_BYTES:
                    continue
                run(route, lambda: spmm_blockplan_xla(plan, b_dev,
                                                      _precision(route)),
                    bm=bm, bk=bk)
    if "densify" in routes:
        run("densify", lambda: xla.spmm_densify_cached(a, b_dev))
    presets = [r for r in routes if r.startswith("densify_")]
    if presets:
        a_dense = jnp.asarray(a.to_dense(), jnp.float32)
        for route in presets:
            run(route, lambda: _dense_dot(a_dense, b_dev,
                                          precision=_precision(route)))
        del a_dense
    if "cusparse" in routes:
        run("cusparse", lambda: vendor.spmm_vendor(a, b_dev))
        out[-1]["lowering"] = vendor.last_lowering(a)
    if "xla_gather" in routes and a.nnz * n * 4 <= GATHER_MAX_BYTES:
        run("xla_gather", lambda: spmm(a, b_dev, method="xla"))
    return out


def _dispatch_floor(repeats: int) -> dict:
    """Host time of one trivial jitted call to completion: the floor under
    every serve time below."""
    from tpuspmm.utils.timing import time_ms

    x = jnp.ones((8, 128), jnp.float32)
    f = jax.jit(lambda v: v + 1)
    ms, _ = time_ms(lambda: f(x), warmup=2, repeats=repeats)
    rec = {"case": "dispatch_floor", "route": "jit(x + 1)", "ms": ms,
           "correct": True}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--quick", action="store_true",
                   help="headline and Llama cases only")
    p.add_argument("--geometries", action="store_true",
                   help=f"also time the kernel at tile shapes {GEOMETRIES}")
    p.add_argument("--repeats", type=int, default=20)
    p.add_argument("--out", default=None, help="write all records here")
    args = p.parse_args(argv)

    from tpuspmm.config import describe_device, enable_compile_cache, platform

    enable_compile_cache()
    if platform() != "gpu":
        print("kernel_compare needs a GPU", file=sys.stderr)
        return 1
    print(json.dumps({"device": describe_device()}), flush=True)
    records = [_dispatch_floor(args.repeats)]
    geoms = GEOMETRIES if args.geometries else GEOMETRIES[:1]
    for name, a, b, routes in _cases(args.quick):
        records += measure_case(name, a, b, routes, repeats=args.repeats,
                                geometries=geoms, device_time=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": describe_device(), "records": records}, f,
                      indent=1)
    return 0 if all(r["correct"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
