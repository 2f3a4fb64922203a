"""Device-mesh helpers.

Axis convention across the package:

- ``"rows"`` — partitions the sparse operand's (and output's) row dimension.
  The SpMM analogue of data parallelism: each device owns a row slab of A
  and computes the matching slab of C.
- ``"cols"`` — partitions the dense operand's (and output's) column
  dimension.  The SpMM analogue of tensor parallelism over the feature dim.

Collectives ride the mesh: the ring variant ppermutes B panels along
``"rows"``, the training step psums dB over ``"rows"``.  The devices of
one host are joined all to all, so the mesh shape follows the algorithm
alone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def mesh_devices(n: Optional[int] = None):
    import jax

    devs = jax.devices()
    return devs if n is None else devs[:n]


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("rows", "cols"),
              devices=None):
    """Build a Mesh.  ``shape=None`` → 1-D mesh over all devices on
    ``axis_names[0]``; otherwise a mesh of the given shape (product must
    not exceed the device count)."""
    import jax
    from jax.sharding import Mesh

    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),)
    names = tuple(axis_names[: len(shape)])
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    grid = np.array(devices[:n]).reshape(shape)
    return Mesh(grid, names)
