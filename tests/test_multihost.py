"""Real multi-process multi-host test.

Spawns two OS processes that form a jax.distributed cluster (2 hosts × 4
CPU devices = 8 global devices) and run the sharded SpMM schedules across
the process boundary — the multi-process code path, which the in-process
8-device tests cannot cover.
"""

import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_cluster():
    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "multihost_worker.py"),
             str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        for i in range(2)
    ]
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=210)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost workers timed out")
        outputs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"proc {i}: OK" in out, out[-2000:]
