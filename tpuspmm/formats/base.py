"""Shared machinery for sparse-format containers.

Replaces the reference's `Matrix` / `SparseMatrix` virtual base classes
(`reference/include/formats/matrix.hpp:10-47`).  Under XLA there is no manual
`allocateSpace`/`copy2Device` lifecycle (`reference/src/formats/sparse_csr.cu:110-161`);
a format instance is a pytree of arrays and `to_device()` / `to_host()` are
whole-pytree transfers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import numpy as np


def _is_jax_array(x: Any) -> bool:
    import jax

    return isinstance(x, jax.Array)


class MatrixBase:
    """Mixin providing placement + common introspection for format dataclasses.

    Subclasses are frozen dataclasses registered as JAX pytrees with the
    array fields as children and everything else static.
    """

    # --- introspection -------------------------------------------------
    shape: Tuple[int, int]

    @property
    def num_rows(self) -> int:
        return self.shape[0]

    @property
    def num_cols(self) -> int:
        return self.shape[1]

    @property
    def sparsity(self) -> float:
        """nnz / (rows*cols) — the reference calls this "sparsity" in its
        report records (reference/include/utils.hpp:37-38)."""
        return float(self.nnz) / float(self.shape[0] * self.shape[1])

    # --- placement ------------------------------------------------------
    def _array_fields(self) -> Sequence[str]:
        return [
            f.name
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), (np.ndarray,)) or _is_jax_array(getattr(self, f.name))
        ]

    def to_device(self, device=None) -> "MatrixBase":
        import jax

        kwargs = {}
        for name in self._array_fields():
            kwargs[name] = jax.device_put(np.asarray(getattr(self, name)), device)
        return dataclasses.replace(self, **kwargs)

    def to_host(self) -> "MatrixBase":
        kwargs = {name: np.asarray(getattr(self, name)) for name in self._array_fields()}
        return dataclasses.replace(self, **kwargs)

    @property
    def on_device(self) -> bool:
        names = self._array_fields()
        return bool(names) and _is_jax_array(getattr(self, names[0]))

    # --- dtype breadth -----------------------------------------------
    # The reference templates its engines over <DT, MT, AccT> and
    # instantiates float and double (reference/src/engine/engine.cpp:63-80,
    # effective support float32-only per SURVEY.md §2.5).  Here any value
    # dtype numpy knows (f32, f64, bf16 via ml_dtypes) can be carried by a
    # container; the f64 path serves the oracle/validation tier, the bf16
    # path the serving tier (kernels multiply bf16 operands in one exact
    # tensor-core dot).  Indices are untouched.
    def astype(self, dtype) -> "MatrixBase":
        """New container with values (and dense blocks) cast to `dtype`."""
        kwargs = {}
        for name in self._array_fields():
            arr = getattr(self, name)
            if name in ("values", "blocks", "data"):
                kwargs[name] = np.asarray(arr).astype(dtype)
        return dataclasses.replace(self, **kwargs)

    @property
    def value_dtype(self):
        for name in ("values", "blocks", "data"):
            arr = getattr(self, name, None)
            if arr is not None:
                return np.asarray(arr).dtype
        return np.dtype(np.float32)


def register_format(cls, data_fields: Sequence[str], meta_fields: Sequence[str]):
    """Register a format dataclass as a JAX pytree."""
    import jax

    jax.tree_util.register_dataclass(cls, list(data_fields), list(meta_fields))
    return cls


def read_header_tokens(path: str, n: int) -> Tuple[int, ...]:
    with open(path, "r") as f:
        toks = f.readline().split()
    return tuple(int(t) for t in toks[:n])
