"""Splice re-run sweep groups into an existing sweep artifact.

Replaces every (testcase, format) group that appears in the PART file
with the part file's records, keeping all other groups — the repair path
for groups that were re-run (e.g. after a crashed ``--isolate`` child)
without regenerating the whole corpus artifact.  The reference's
append-only .json accumulation has no repair story at all
(reference/test/csr.sh:3-14 just re-appends); one-generation artifacts
need one.

Usage::

    python -m bench.splice_sweep --into chiprun_out/formats.jsonl \
        --part chiprun_out/resweep.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def splice(into_path: str, part_path: str) -> dict:
    part = [json.loads(l) for l in open(part_path) if l.strip()]
    groups = {(r.get("testcase"), r.get("format")) for r in part}
    kept, dropped = [], 0
    for line in open(into_path):
        if not line.strip():
            continue
        r = json.loads(line)
        if (r.get("testcase"), r.get("format")) in groups:
            dropped += 1
        else:
            kept.append(line.rstrip("\n"))
    kept += [json.dumps(r) for r in part]
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(into_path) or ".")
    with os.fdopen(fd, "w") as f:
        f.write("\n".join(kept) + "\n")
    os.replace(tmp, into_path)  # atomic: never a half-written artifact
    return {"groups_replaced": sorted(f"{t}/{fm}" for t, fm in groups),
            "records_dropped": dropped, "records_added": len(part),
            "records_total": len(kept)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--into", required=True, help="artifact to repair")
    p.add_argument("--part", required=True, help="re-run group records")
    args = p.parse_args(argv)
    print(json.dumps(splice(args.into, args.part)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
