"""Summarize sweep JSONL records into a markdown table.

Reads the newline-delimited JSON produced by bench/sweep_formats,
bench/sweep_sparsity, or the CLI's --out, groups by (testcase, format),
and reports the best kernel per group with correctness counts — the
human-readable layer the reference left to a plotting notebook
(SURVEY.md §4: "no assertion layer — a human inspects the JSON").

Usage::

    python -m bench.summarize chiprun_out/formats.jsonl [--csv]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict


def load(paths):
    records = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line.startswith("{"):
                    records.append(json.loads(line))
    return records


def summarize(records):
    groups = defaultdict(list)
    # --isolate parents write sweep_incomplete markers with only
    # (testcase, format) — no operand provenance — so they must flag
    # EVERY provenance-keyed group of that (testcase, format) rather
    # than forming a phantom ("", "") group of their own: a truncated
    # group must never read as complete-and-green
    incomplete_groups = set()
    for r in records:
        if r.get("sweep_incomplete") == "1":
            incomplete_groups.add((r.get("testcase", "?"),
                                   r.get("format", "?")))
            continue
        # operand provenance is part of the group key: a width-1024 bf16
        # record must not share a "best kernel" row with the width-256
        # f32 run of the same dir.  Legacy records
        # without the fields collapse into one ("", "") bucket per
        # (testcase, format), preserving the old behaviour.
        groups[(r.get("testcase", "?"), r.get("format", "?"),
                r.get("bCols", ""), r.get("bDtype", ""))].append(r)
    # a marker whose group shipped NO records at all still needs a row
    for tc, fmt in incomplete_groups:
        if not any(k[0] == tc and k[1] == fmt for k in groups):
            groups[(tc, fmt, "", "")] = []
    rows = []
    for (tc, fmt, bcols, bdt), recs in sorted(
            groups.items(), key=lambda kv: tuple(map(str, kv[0]))):
        timed = [r for r in recs
                 if r.get("correct") == "1"
                 and r.get("kernelTimeMs", 0) > 0
                 and r.get("kernelType") not in ("0",)]
        # Errored records (device fault / OOM: correct=="" + error field)
        # are their own category: a fault must never read as a numerics
        # failure in the tally.
        n_bad = sum(r.get("correct") == "0" for r in recs)
        n_err = sum(r.get("correct", "") == "" and bool(r.get("error"))
                    for r in recs)
        # an --isolate parent marks a group whose child crashed — a
        # truncated group must never read as complete-and-green
        incomplete = (tc, fmt) in incomplete_groups
        best = min(timed, key=lambda r: r["kernelTimeMs"]) if timed else None
        vendor = next((r for r in timed if r.get("kernelType") == "-1"), None)
        rows.append({
            "testcase": tc,
            "format": fmt,
            "bCols": bcols,
            "bDtype": bdt,
            "records": len(recs),
            "incorrect": n_bad,
            "errored": n_err,
            "incomplete": "yes" if incomplete else "",
            "best_kernel": best.get("kernelName") or best.get("kernelType") if best else "-",
            "best_ms": best["kernelTimeMs"] if best else None,
            "gflops": best.get("gflops") if best else None,
            "vs_vendor": (vendor["kernelTimeMs"] / best["kernelTimeMs"]
                          if best and vendor else None),
        })
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("paths", nargs="+")
    p.add_argument("--csv", action="store_true")
    args = p.parse_args(argv)
    rows = summarize(load(args.paths))
    if not rows:
        print("no records", file=sys.stderr)
        return 1
    cols = list(rows[0].keys())
    if args.csv:
        print(",".join(cols))
        for r in rows:
            print(",".join(str(r[c]) for c in cols))
    else:
        print("| " + " | ".join(cols) + " |")
        print("|" + "|".join("---" for _ in cols) + "|")
        for r in rows:
            print("| " + " | ".join(str(r[c]) for c in cols) + " |")
    total_bad = sum(r["incorrect"] for r in rows)
    total_err = sum(r["errored"] for r in rows)
    total_inc = sum(1 for r in rows if r["incomplete"])
    print(f"\n{len(rows)} groups, {total_bad} incorrect records total"
          f" ({total_err} errored — correctness unknown;"
          f" {total_inc} groups truncated)",
          file=sys.stderr)
    return 0 if total_bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
