"""Summarize a jax.profiler trace into device occupancy numbers.

A profiler capture of a served kernel turns arithmetic estimates into
measurement: which operations take the device's time, and how much of
the window the device is idle.  The reference planned Nsight-Compute
profiling but shipped no artifacts (SURVEY.md §5); this reads the
Chrome-trace JSON that ``jax.profiler.start_trace`` writes.

Usage::

    python -m tpuspmm.cli --csr -d data/large_25605 --width 256 \
        --kernel 3 --trace chiprun_out/trace    # 3 = triton_blocksparse
    python -m bench.trace_report chiprun_out/trace \
        [--out chiprun_out/trace_report.json]

Output: one JSON object — per-track busy time and busy fraction (the
union of the track's event intervals over its span, so overlapping or
nested events are not counted twice) for the GPU's ``/device:GPU:N``
tracks, plus the top device ops by total duration.  ok=false with a
reason when the trace holds no device track.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import sys


def find_trace_json(log_dir: str) -> str | None:
    pats = sorted(glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "*.trace.json.gz")))
    return pats[-1] if pats else None


def load_events(path: str):
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", data if isinstance(data, list) else [])


def _is_device(name: str) -> bool:
    return "/device:gpu:" in name.lower()


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(events):
    pids, tids = {}, {}
    for e in events:
        if e.get("ph") == "M":
            if e.get("name") == "process_name":
                pids[e["pid"]] = e["args"].get("name", str(e["pid"]))
            elif e.get("name") == "thread_name":
                tids[(e["pid"], e.get("tid"))] = e["args"].get("name", "")
    tracks = collections.defaultdict(lambda: {"intervals": [], "events": 0,
                                              "t0": float("inf"),
                                              "t1": 0.0})
    ops = collections.Counter()
    op_calls = collections.Counter()
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        pname = pids.get(e["pid"], str(e.get("pid")))
        tname = tids.get((e["pid"], e.get("tid")), "")
        key = f"{pname}/{tname}" if tname else pname
        t = tracks[key]
        t["intervals"].append((e["ts"], e["ts"] + e["dur"]))
        t["events"] += 1
        t["t0"] = min(t["t0"], e["ts"])
        t["t1"] = max(t["t1"], e["ts"] + e["dur"])
        # device op names live on device-process tracks
        if _is_device(pname):
            ops[e.get("name", "?")] += e["dur"]
            op_calls[e.get("name", "?")] += 1
    out = {}
    for key, t in tracks.items():
        span = max(t["t1"] - t["t0"], 1e-9)
        busy = union_us(t["intervals"])
        out[key] = {"busy_ms": busy / 1e3, "span_ms": span / 1e3,
                    "busy_frac": busy / span, "events": t["events"]}
    top = [{"op": name, "total_ms": us / 1e3, "calls": op_calls[name],
            "mean_us": us / max(op_calls[name], 1)}
           for name, us in ops.most_common(15)]
    return out, top


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("trace_dir")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    path = find_trace_json(args.trace_dir)
    if path is None:
        rec = {"ok": False,
               "reason": f"no *.trace.json.gz under {args.trace_dir}"}
    else:
        tracks, top = summarize(load_events(path))
        device_tracks = {k: v for k, v in tracks.items() if _is_device(k)}
        rec = {"ok": bool(device_tracks), "trace": path,
               "device_tracks": device_tracks, "top_ops": top}
        if not device_tracks:
            rec["reason"] = ("trace contains only host tracks: " +
                             ", ".join(sorted(tracks)[:8]))
            rec["host_tracks"] = tracks
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
