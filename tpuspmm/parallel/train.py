"""Distributed least-squares training step — the framework's "full training
step" demonstrator.

Problem: given a sparse operator A (M×K) and a target C (M×N), learn the
dense operand B minimizing 0.5·‖A@B − C‖².  This is the training-shaped
use of SpMM (pruned-LLM layers: frozen sparse weights, dense activations
being optimized / gradients flowing through the sparse matmul).

Mesh mapping (2-D mesh from tpuspmm.parallel.mesh):

- ``"rows"`` shards A's rows and C's rows  (data-parallel analogue);
- ``"cols"`` shards B's and C's columns    (tensor-parallel analogue);
- B is replicated over ``"rows"``; its gradient is a contraction over the
  row-sharded M dimension, so dB takes a ``psum`` over ``"rows"`` — the
  canonical gradient collective.

Both matmuls are gather + segment-sum over each shard's tile plan read
as triplets: the forward on the row-slab plan, the backward
(dB = Aᵀ@res) on the *transposed* per-slab plan
(tpuspmm/parallel/shard.py shard_rows_tileplan_transposed).  The
reference is forward-only (no autograd anywhere); this is new-build
capability.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuspmm.kernels.common import round_up
from tpuspmm.ops.xla import spmm_triplets
from tpuspmm.parallel.shard import (
    shard_rows_tileplan, shard_rows_tileplan_transposed)


def make_train_state(a, n: int, mesh: Mesh, seed: int = 0) -> Dict:
    """Shard A (forward + transposed tile plans), B and C onto the mesh
    and return the training state.

    B is initialised randomly; the target C is a random dense matrix (in a
    real pruned-LLM setting it would be activations/labels).
    """
    n_rows = mesh.shape["rows"]
    n_cols = mesh.shape["cols"]
    fwd = shard_rows_tileplan(a, n_rows)
    bwd = shard_rows_tileplan_transposed(a, n_rows)
    m, k = fwd.shape
    m_local = fwd.m_local
    k_pad = fwd.num_k_tiles * fwd.tile_k
    n_local = round_up(-(-n // n_cols), 128)
    n_pad = n_local * n_cols

    rng = np.random.default_rng(seed)
    b0 = rng.standard_normal((k_pad, n_pad)).astype(np.float32) * 0.02
    c_target = rng.standard_normal((m_local * n_rows, n_pad)).astype(np.float32)

    put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    plan_arrays = lambda p: {
        "rt": put(p.rt, P("rows")), "kt": put(p.kt, P("rows")),
        "rows": put(p.rows, P("rows")),
        "cols": put(p.cols, P("rows")), "vals": put(p.vals, P("rows")),
    }
    return {
        "fwd": plan_arrays(fwd),
        "bwd": plan_arrays(bwd),
        "b": put(b0, P(None, "cols")),
        "c_target": put(c_target, P("rows", "cols")),
        "meta": {
            "m": m, "k": k, "m_local": m_local, "k_pad": k_pad,
            "n": n, "n_pad": n_pad, "n_local": n_local,
            "fwd_static": dict(tm=fwd.tile_m, tk=fwd.tile_k),
            "bwd_static": dict(tm=bwd.tile_m, tk=bwd.tile_k),
        },
    }


def _freeze(d: dict) -> tuple:
    return tuple(sorted(d.items()))


@functools.lru_cache(maxsize=64)
def _train_step_callable(mesh: Mesh, m_local: int, k_pad: int,
                         fwd_static: tuple, bwd_static: tuple):
    """Jitted shard_map step, cached per (mesh, geometry) — building it
    inside lsq_train_step would retrace+recompile every step.  ``lr`` is a
    traced argument so sweeping it costs no recompile."""
    from tpuspmm.parallel.spmm import _tileplan_triplets

    def plan_spmm(p, x, num_rows, tm, tk):
        gr, gc, v = _tileplan_triplets(p["rt"][0], p["kt"][0], p["rows"][0],
                                       p["cols"][0], p["vals"][0], tm, tk)
        return spmm_triplets(gr, gc, v, x, num_rows=num_rows)

    def local_fn(fwd, bwd, b, c_tgt, lr):
        c_hat = plan_spmm(fwd, b, m_local, **dict(fwd_static))
        res = c_hat - c_tgt
        loss = 0.5 * jnp.sum(res * res)
        loss = jax.lax.psum(jax.lax.psum(loss, "rows"), "cols")
        # backward: dB = A_sᵀ @ res via the transposed tile plan, then the
        # contraction over the row-sharded M dimension completes as a psum
        db = plan_spmm(bwd, res, k_pad, **dict(bwd_static))
        db = jax.lax.psum(db, "rows")
        return b - lr * db, loss

    return jax.jit(jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=({k: P("rows") for k in
                   ("rt", "kt", "rows", "cols", "vals")},) * 2
                 + (P(None, "cols"), P("rows", "cols"), P()),
        out_specs=(P(None, "cols"), P()),
        check_vma=False,
    ))


def lsq_train_step(state: Dict, mesh: Mesh, lr: float = 1e-2):
    """One jitted, fully-sharded SGD step.  Returns (new_state, loss)."""
    meta = state["meta"]
    fn = _train_step_callable(
        mesh, meta["m_local"], meta["k_pad"],
        _freeze(meta["fwd_static"]), _freeze(meta["bwd_static"]))
    new_b, loss = fn(state["fwd"], state["bwd"], state["b"],
                     state["c_target"], jnp.float32(lr))
    new_state = dict(state)
    new_state["b"] = new_b
    return new_state, loss
