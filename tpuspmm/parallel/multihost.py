"""Multi-process initialization and mesh construction.

The reference has no distributed backend at all (SURVEY.md §5 — single
process, hard-coded GPU).  Multi-process execution is coordinator-based:
every process runs the same program, calls ``jax.distributed.initialize``
with the coordinator's address, and sees the global device set; the
collectives are transparent behind the mesh.

Typical use::

    from tpuspmm.parallel import multihost
    multihost.initialize("localhost:1234", num_processes=2, process_id=i)
    mesh = multihost.global_mesh(("rows",))  # all global devices, 1-D
    C = spmm_row_sharded(A, B, mesh)         # same code as one process

Without a coordinator (none given, none named by the environment)
``initialize`` does nothing and ``global_mesh`` is the local-device mesh.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

_initialized = False

# environment variables through which a launcher names the coordinator
COORDINATOR_ENV = ("JAX_COORDINATOR_ADDRESS",)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed when a coordinator is given, or named by
    the environment (``JAX_COORDINATOR_ADDRESS``).  Returns True when
    distributed mode is active, False when there is no coordinator to
    join.  A failure to join one raises: no process silently runs alone
    on a sub-mesh."""
    global _initialized
    import jax

    if _initialized:
        return True
    if coordinator_address is None:
        coordinator_address = next(
            (os.environ[v] for v in COORDINATOR_ENV if os.environ.get(v)),
            None)
    if coordinator_address is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    return True


def global_mesh(axis_names: Sequence[str] = ("rows",),
                shape: Optional[Tuple[int, ...]] = None):
    """Mesh over the GLOBAL device set (all processes).

    1-D by default; pass ``shape`` for 2-D (e.g. ``(num_processes,
    devices_per_process)`` so a ring axis stays inside one host).
    """
    import jax

    from tpuspmm.parallel.mesh import make_mesh

    devices = jax.devices()  # global across processes after initialize()
    if shape is None:
        shape = (len(devices),)
    return make_mesh(shape, axis_names if len(axis_names) >= len(shape)
                     else tuple(axis_names) + ("cols",), devices=devices)


def process_info() -> dict:
    import jax

    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
