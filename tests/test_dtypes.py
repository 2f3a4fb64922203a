"""Dtype breadth: bf16 dense-operand ingestion and f64 value containers.

The reference templates its engines over <DT, MT, AccT> and instantiates
float and double (reference/src/engine/engine.cpp:63-80) though only
float32 is effectively exercised (SURVEY.md §2.5).  The rebuild's answer:

- B may be ingested in bfloat16 (the pruned-LLM serving dtype): every
  compute path accumulates in >= f32 and is gate-checked against the f64
  oracle *of the bf16-ingested operand*;
- containers carry any numpy value dtype via .astype(); the f64 path
  serves the oracle/validation tier.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tpuspmm.formats import CSR, convert
from tpuspmm.ops import oracle, xla
from tpuspmm.kernels import blocksparse_gpu
from tpuspmm.utils.compare import allclose


@pytest.fixture(scope="module")
def case():
    a = CSR.random(200, 300, 0.05, seed=21, lo=-1, hi=1)
    rng = np.random.default_rng(22)
    b32 = rng.standard_normal((300, 64)).astype(np.float32)
    b16 = jnp.asarray(b32, dtype=jnp.bfloat16)
    # the oracle of the *ingested* operand: f64 of the bf16 values
    ref = oracle.spmm_oracle(a, np.asarray(b16).astype(np.float64))
    return a, b16, ref


def test_bf16_ingestion_pallas_kernels(case):
    a, b16, ref = case
    from bench.kernel_compare import plan_of

    for bm, bk in ((16, 16), (64, 64)):
        out = np.asarray(blocksparse_gpu.spmm_blocksparse(
            plan_of(a, bm, bk), b16, interpret=True))
        assert out.dtype == np.float32  # f32 accumulation/output
        assert allclose(out, ref, 1e-2, 1e-3), (bm, bk)


def test_bf16_ingestion_xla_paths(case):
    a, b16, ref = case
    out = np.asarray(xla.spmm_csr_xla(a, b16))
    assert out.dtype == np.float32
    assert allclose(out, ref, 1e-2, 1e-3)
    out = np.asarray(xla.spmm_densify(
        jnp.asarray(np.asarray(a.to_coo().rows)),
        jnp.asarray(np.asarray(a.to_coo().cols)),
        jnp.asarray(np.asarray(a.to_coo().values)), b16,
        num_rows=a.shape[0], num_cols=a.shape[1]))
    assert out.dtype == np.float32
    assert allclose(out, ref, 1e-2, 1e-3)


def test_bf16_ingestion_bsr_ell(case):
    a, b16, ref = case
    bsr = convert.to_format(a.to_scipy(), "bsr")
    out = np.asarray(xla.spmm_bsr_xla(bsr, b16))
    assert allclose(out, ref, 1e-2, 1e-3)
    ell = convert.to_format(a.to_scipy(), "ell")
    out = np.asarray(xla.spmm_ell_xla(ell, b16))
    assert allclose(out, ref, 1e-2, 1e-3)


def test_f64_value_containers():
    a = CSR.random(60, 80, 0.1, seed=23)
    a64 = a.astype(np.float64)
    assert a64.value_dtype == np.float64
    assert a64.nnz == a.nnz
    b = np.random.default_rng(24).standard_normal((80, 16))
    # the f64 oracle of the f64 container equals numpy dense math exactly
    out = oracle.spmm_oracle(a64, b)
    expect = a.to_scipy().astype(np.float64) @ b
    np.testing.assert_allclose(out, expect.astype(np.float32), rtol=1e-6)


def test_astype_round_trip_bf16_values():
    import ml_dtypes

    a = CSR.random(50, 50, 0.1, seed=25, lo=-1, hi=1)
    a16 = a.astype(ml_dtypes.bfloat16)
    assert a16.value_dtype == ml_dtypes.bfloat16
    back = a16.astype(np.float32)
    # bf16 round trip loses at most 2^-9 relative
    np.testing.assert_allclose(np.asarray(back.values),
                               np.asarray(a.values), rtol=4e-3)


def test_bf16_ingestion_densify_and_vendor(case):
    """The cached densify (cuBLAS) and the vendor route accept a
    bf16-ingested B and stay gate-exact vs the f64 oracle of the bf16
    operand."""
    from tpuspmm.ops import vendor

    a, b16, ref = case
    for name, fn in [("densify", lambda: xla.spmm_densify_cached(a, b16)),
                     ("vendor", lambda: vendor.spmm_vendor(a, b16))]:
        out = np.asarray(fn())
        assert out.dtype == np.float32, name
        assert allclose(out, ref, 1e-2, 1e-3), name


def _count_dots(fn, *args):
    import jax

    jaxpr = jax.make_jaxpr(fn)(*args)
    return str(jaxpr).count("dot_general")


def test_split_dot_pass_ladder():
    """The kernel's precision ladder issues the fewest bf16 dots that keep
    f32 accuracy for the operand dtypes: bf16 x bf16 is one exact dot,
    one f32 side three, f32 x f32 six."""
    from tpuspmm.kernels.blocksparse_gpu import _split_dot

    a16 = jnp.zeros((32, 64), jnp.bfloat16)
    a32 = jnp.zeros((32, 64), jnp.float32)
    b16 = jnp.zeros((64, 32), jnp.bfloat16)
    b32 = jnp.zeros((64, 32), jnp.float32)
    assert _count_dots(_split_dot, a16, b16) == 1
    assert _count_dots(_split_dot, a16, b32) == 3
    assert _count_dots(_split_dot, a32, b16) == 3
    assert _count_dots(_split_dot, a32, b32) == 6
