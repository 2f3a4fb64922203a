"""Worker for the real multi-process multi-host test (test_multihost.py).

Each process initializes jax.distributed against a shared coordinator,
sees the global (all-process) device set, and runs the row-sharded and
ring SpMM schedules over the global mesh — the multi-process code path,
exercised with CPU devices across OS processes.

Invoked as:  python tests/multihost_worker.py <process_id> <num_processes> <port>
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)

pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["TPUSPMM_INTERPRET"] = "1"

from tpuspmm.parallel import multihost  # noqa: E402

assert multihost.initialize(f"localhost:{port}", num_processes=nprocs,
                            process_id=pid)

import numpy as np
from jax.experimental import multihost_utils

from tpuspmm.formats import CSR
from tpuspmm.ops import oracle
from tpuspmm.parallel import spmm_ring, spmm_row_sharded
from tpuspmm.utils.compare import allclose

info = multihost.process_info()
assert info["process_count"] == nprocs, info
assert info["global_devices"] == 4 * nprocs, info
mesh = multihost.global_mesh(("rows",))

a = CSR.random(160, 240, 0.06, seed=3)
b = np.random.default_rng(0).standard_normal((240, 32)).astype(np.float32)
ref = oracle.spmm_oracle(a, b)

for name, out in (
    ("row_sharded", spmm_row_sharded(a, b, mesh, local="xla")),
    ("ring", spmm_ring(a, b, mesh)),
):
    full = multihost_utils.process_allgather(out, tiled=True)
    ok = allclose(np.asarray(full), ref, 1e-2, 1e-3)
    print(f"proc {pid}: {name} correct={ok}", flush=True)
    assert ok, name

print(f"proc {pid}: OK", flush=True)
