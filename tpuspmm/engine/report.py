"""Timing-record emission.

Schema parity with the reference's `reportTime`
(reference/include/utils.hpp:24-49), which prints one JSON object per run:
testcase / sparsity / format / kernelType / denseOrdering / correct /
cudaPrologTimeMs / cudaKernelTimeMs / cudaEpilogTimeMs / cudaTotalTimeMs /
sequentialTimeMs.  Here the time fields drop the "cuda" prefix, the
sequential-time field carries the measured oracle time (the reference
prints a hard-coded 0, utils.hpp:48 — a known bug, SURVEY.md §2.5), and
throughput fields (GFLOP/s, nnz/s, share of the device-memory roofline)
are added.  Every record names the device it ran on.
"""

from __future__ import annotations

import functools
import json
import sys
from typing import Optional

# Peak device-memory bandwidth (bytes/s) by the device_kind JAX reports.
# Source: NVIDIA H100 data sheet (SXM5 3.35 TB/s, PCIe 2.0 TB/s).
PEAK_MEM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def peak_mem_bytes_per_s(platform: str, kind: str) -> Optional[float]:
    """Peak bandwidth of the device, None on the CPU (no roofline is
    written there).  A GPU the table does not hold is an error: no peak is
    assumed."""
    if platform == "cpu":
        return None
    if kind not in PEAK_MEM_BYTES_PER_S:
        raise KeyError(f"no peak bandwidth for device {kind!r}; add it to "
                       "report.PEAK_MEM_BYTES_PER_S with its source")
    return PEAK_MEM_BYTES_PER_S[kind]


@functools.lru_cache(maxsize=1)
def device_fields() -> dict:
    """platform / deviceKind / card (nvidia-smi name and power limit) of
    the device every record of this process ran on."""
    from tpuspmm.config import describe_device

    d = describe_device()
    return {"platform": d["platform"], "deviceKind": d["kind"],
            "card": d["card"]}


def spmm_flops(nnz: int, n: int) -> int:
    """2 flops per nnz per output column (multiply-accumulate)."""
    return 2 * nnz * n


def spmm_min_bytes(nnz: int, m: int, k: int, n: int, index_bytes: int = 4) -> int:
    """Least device-memory traffic: read values+indices once, read B once,
    write C once (B re-reads are what good kernels avoid)."""
    return nnz * (4 + index_bytes) + k * n * 4 + m * n * 4


def make_record(
    *,
    testcase: str,
    sparsity: float,
    fmt: str,
    kernel_type,
    kernel_name: str = "",
    correct: Optional[bool] = None,
    prolog_ms: float = 0.0,
    kernel_ms: float = 0.0,
    epilog_ms: float = 0.0,
    sequential_ms: float = 0.0,
    nnz: int = 0,
    shape=(0, 0),
    n: int = 0,
    dense_ordering: str = "row_major",
    extra: Optional[dict] = None,
) -> dict:
    total = prolog_ms + kernel_ms + epilog_ms
    dev = device_fields()
    rec = {
        "testcase": testcase,
        "sparsity": sparsity,
        "format": fmt,
        "kernelType": str(kernel_type),
        "kernelName": kernel_name,
        "denseOrdering": dense_ordering,
        "correct": ("1" if correct else "0") if correct is not None else "",
        "prologTimeMs": prolog_ms,
        "kernelTimeMs": kernel_ms,
        "epilogTimeMs": epilog_ms,
        "totalTimeMs": total,
        "sequentialTimeMs": sequential_ms,
        **dev,
        # operand provenance: records self-describe the dense operand
        "bCols": int(n),
    }
    if kernel_ms > 0 and nnz and n:
        secs = kernel_ms / 1e3
        rec["gflops"] = spmm_flops(nnz, n) / secs / 1e9
        rec["nnzPerSec"] = nnz / secs
        peak = peak_mem_bytes_per_s(dev["platform"], dev["deviceKind"])
        if peak is not None:
            sol_secs = spmm_min_bytes(nnz, shape[0], shape[1], n) / peak
            rec["memRooflineFraction"] = sol_secs / secs
    if extra:
        rec.update(extra)
    return rec


def emit(record: dict, stream=None) -> None:
    print(json.dumps(record), file=stream or sys.stdout, flush=True)
