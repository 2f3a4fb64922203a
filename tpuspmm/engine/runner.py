"""run_engine — orchestrate one format's full verification/timing pass.

Counterpart of the reference driver `runEngine`
(reference/src/engine/engine.cpp:16-61): run the sequential oracle (kernel
0), then every optimized variant (1..N) verified against the oracle at
rel 1e-2 / abs 1e-3 (reference/include/utils.hpp:10-11), then the vendor
baseline (kernel -1).  One JSON record per run, like reportTime
(utils.hpp:24-49).

Differences by design:
- the vendor result IS correctness-checked (the reference drops it
  unchecked, engine.cpp:51 — SURVEY.md §3.3);
- kernel time is steady-state (tpuspmm.utils.timing: median over
  `repeats` after a warmup), with compile/preprocessing time reported as
  prolog — the reference's prolog is its H2D+layout time (e.g.
  spmm_csr_k2.cu:64-74);
- epilog is the device→host fetch of the result, as in the reference
  (copy2Host, spmm_csr_k2.cu:91);
- a variant that cannot run is recorded with the reason, and a variant
  whose run or timer raises is recorded as an error.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from tpuspmm.config import Config, default_config
from tpuspmm.engine.registry import Engine
from tpuspmm.engine import report as report_mod
from tpuspmm.ops import oracle as oracle_mod
from tpuspmm.utils.compare import allclose


def run_engine(
    engine: Engine,
    a,
    b,
    *,
    testcase: str = "",
    config: Optional[Config] = None,
    skip_seq: bool = False,
    run_vendor: bool = True,
    repeats: int = 3,
    emit=True,
) -> List[dict]:
    """Run oracle + all variants + vendor; return (and optionally print)
    one record per run."""
    import jax
    import jax.numpy as jnp

    from tpuspmm.utils.timing import time_ms

    config = config or default_config()
    # respect a bf16-ingested dense operand (the pruned-LLM serving
    # dtype — CLI --b-dtype bf16): every variant and both oracles then
    # compute on the bf16 values (the oracles upcast them to f64), so
    # the gate checks the numerics of the operand actually served;
    # anything else is normalised to the reference's float32
    # (reference/src/main.cu:185).
    b_host = np.asarray(b)
    if b_host.dtype.name != "bfloat16":
        b_host = b_host.astype(np.float32)
    records: List[dict] = []
    common = dict(
        testcase=testcase,
        sparsity=a.sparsity,
        fmt=engine.fmt,
        nnz=a.nnz,
        shape=a.shape,
        n=b_host.shape[1],
    )

    # ---- kernel 0: sequential oracle (engine.cpp:30-37) -----------------
    seq_ms = 0.0
    ref = None
    if not skip_seq:
        t0 = time.perf_counter()
        ref = oracle_mod.spmm_oracle(a, b_host)
        seq_ms = (time.perf_counter() - t0) * 1e3
        rec = report_mod.make_record(
            kernel_type=0, kernel_name="oracle_numpy_f64",
            correct=True, sequential_ms=seq_ms, **common,
        )
        records.append(rec)
    else:
        # still need a reference for verification — use the scipy oracle
        ref = oracle_mod.spmm_scipy_oracle(a, b_host)

    b_dev = jnp.asarray(b_host)

    def timed_run(fn_of_b):
        """prolog = first call (preprocessing + compile + transfer) less
        one steady call; kernel = the timer's median; epilog = the
        device→host fetch."""
        t0 = time.perf_counter()
        jax.block_until_ready(fn_of_b(b_dev))
        first_ms = (time.perf_counter() - t0) * 1e3
        kernel_ms, out = time_ms(lambda: fn_of_b(b_dev), warmup=0,
                                 repeats=repeats)
        prolog_ms = max(0.0, first_ms - kernel_ms)
        t2 = time.perf_counter()
        host = np.asarray(out)
        epilog_ms = (time.perf_counter() - t2) * 1e3
        return host, prolog_ms, kernel_ms, epilog_ms

    # ---- kernels 1..N (engine.cpp:41-43) --------------------------------
    def record(number, name, fn, extra=None):
        try:
            host, prolog_ms, kernel_ms, epilog_ms = timed_run(fn)
            ok = allclose(host, ref, rel_tol=config.rel_tol,
                          abs_tol=config.abs_tol)
            return report_mod.make_record(
                kernel_type=number, kernel_name=name, correct=ok,
                prolog_ms=prolog_ms, kernel_ms=kernel_ms,
                epilog_ms=epilog_ms, sequential_ms=seq_ms,
                extra=extra() if extra else None, **common)
        except Exception as e:
            # correct stays "" (unknown): a fault is not a numerics
            # failure — the reference only writes its correct field after
            # a completed allclose (spmm_csr_k1.cu:76-81)
            return report_mod.make_record(
                kernel_type=number, kernel_name=name,
                extra={"error": f"{type(e).__name__}: {e}"}, **common)

    for variant in engine.variants:
        reason = variant.inadmissible_reason(a, b_host, config)
        if reason:
            # mirror K4's bail-out record (spmm_csr_k4.cu:92-101), but
            # label it explicitly instead of all-zeros
            records.append(report_mod.make_record(
                kernel_type=variant.number, kernel_name=variant.name,
                extra={"skipped": "inadmissible", "reason": reason},
                **common))
            continue
        interp = {"interpreted": "1" if config.resolve_interpret() else "0"}
        records.append(record(variant.number, variant.name,
                              lambda bb, v=variant: v.fn(a, bb, config),
                              extra=(lambda: interp) if variant.requires_gpu
                              else None))

    # ---- kernel -1: vendor baseline (engine.cpp:47-55) ------------------
    if run_vendor and engine.supports_vendor:
        from tpuspmm.ops import vendor

        records.append(record(
            -1, "vendor_cusparse", lambda bb: vendor.spmm_vendor(a, bb),
            extra=lambda: {"vendorLowering": vendor.last_lowering(a)}))

    bdt = "bf16" if b_host.dtype.name == "bfloat16" else "f32"
    for rec in records:
        rec["bDtype"] = bdt
    if emit:
        for rec in records:
            report_mod.emit(rec)
    return records
