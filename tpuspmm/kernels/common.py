"""Shared kernel utilities."""

from __future__ import annotations

import jax.numpy as jnp


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def split_bf16(x, terms: int = 3):
    """bf16 multi-term decomposition: x ≈ Σ parts, every part exactly
    representable in bf16.  Each term adds ~8 mantissa bits: 2 terms carry
    ~2^-16 relative fidelity, 3 terms ~2^-24 (f32's own rounding).

    A product of two bf16 parts is exact in f32, so Σ_ij a_i·b_j over the
    terms of order ≥ 2^-16 reproduces an f32 product on bf16 tensor cores
    (the block-sparse kernel's precision ladder)."""
    parts = []
    rem = x
    for i in range(terms):
        p = rem.astype(jnp.bfloat16)
        parts.append(p)
        if i + 1 < terms:
            rem = rem - p.astype(jnp.float32)
    return parts
