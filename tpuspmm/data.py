"""Benchmark-corpus resolution.

The reference hard-wires its corpus at ``../data`` relative to the build
tree (reference/test/csr.sh:3-14); round 1 of this build hard-depended on
the read-only reference mount instead.  The corpus now ships in the repo
(``data/``, rebuilt/verified by ``python -m tpuspmm.tools.make_data``),
and every consumer resolves directories through here:

1. ``$TPUSPMM_DATA`` if set,
2. the repo's own ``data/`` tree.
"""

from __future__ import annotations

import os
from typing import Optional

_REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def data_roots() -> list:
    roots = []
    env = os.environ.get("TPUSPMM_DATA")
    if env:
        roots.append(env)
    roots.append(_REPO_DATA)
    return [r for r in roots if os.path.isdir(r)]


def data_root() -> Optional[str]:
    roots = data_roots()
    return roots[0] if roots else None


def data_dir(name: str) -> Optional[str]:
    """Absolute path of corpus directory `name`, or None if absent."""
    for root in data_roots():
        d = os.path.join(root, name)
        if os.path.isdir(d):
            return d
    return None
