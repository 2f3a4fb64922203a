"""Global configuration and the one device helper of tpuspmm.

The CUDA reference hard-codes its knobs at compile time — tolerances at
`reference/include/utils.hpp:10-11` and the device pin at
`reference/src/main.cu:176`.  Here everything is a runtime dataclass so the
CLI, engine, tests, and benchmarks share one config object.

Device questions (which platform, which card) are answered in one place:
:func:`platform` and :func:`device_kind`.  Nothing else in the package
reads a backend name.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def platform() -> str:
    """Platform of the first JAX device: ``"gpu"`` on a CUDA card,
    ``"cpu"`` otherwise."""
    import jax

    return jax.devices()[0].platform


def device_kind() -> str:
    """``device_kind`` of the first JAX device, as JAX reports it (e.g.
    "NVIDIA H100 80GB HBM3"); the key of every per-device table."""
    import jax

    return jax.devices()[0].device_kind


def card_name_and_power() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (one
    line per card, joined by "; "), or "" where there is no nvidia-smi."""
    import subprocess

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return "; ".join(line.strip() for line in res.stdout.splitlines()
                     if line.strip())


def describe_device() -> dict:
    """What every record carries about the device it ran on."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_name_and_power()}


def should_interpret(interpret: Optional[bool] = None) -> bool:
    """Run Pallas kernels interpreted only when asked: an explicit
    ``interpret=True``, or ``TPUSPMM_INTERPRET=1`` in the environment
    (the test suite sets it).  Never chosen from the platform."""
    if interpret is not None:
        return bool(interpret)
    return os.environ.get("TPUSPMM_INTERPRET") == "1"


def enable_compile_cache(repo_root: Optional[str] = None) -> str:
    """Place JAX's persistent compilation cache for an entry point.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it is (JAX
    reads it itself) and nothing else is set.  Otherwise the cache goes to
    the fixed ``.jax_cache/`` of the checkout, so later runs from the same
    checkout find what earlier ones compiled.  Returns the directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    root = repo_root or os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


@dataclasses.dataclass
class Config:
    # Correctness gate — mirrors reference REL_TOL/ABS_TOL
    # (reference/include/utils.hpp:10-11, used via torch::allclose in every
    # kernel wrapper, e.g. reference/src/spmm/csr/spmm_csr_k1.cu:76-81).
    rel_tol: float = 1e-2
    abs_tol: float = 1e-3

    # Run Pallas kernels interpreted (None: only when TPUSPMM_INTERPRET=1).
    interpret: Optional[bool] = None

    def resolve_interpret(self) -> bool:
        return should_interpret(self.interpret)


_default: Optional[Config] = None


def default_config() -> Config:
    global _default
    if _default is None:
        _default = Config()
    return _default
