"""Frozen copy of ``zeth_tpu_torch/field.py`` (Baby Bear on torch
int32 tensors in Montgomery form, plain torch); the benchmark's yardstick, so it does not follow later
changes to the program.
"""

from __future__ import annotations

import torch

from .hostmath import BETA, P, R, R2, RINV, ROU_FWD, ROU_REV  # noqa: F401

I32 = torch.int32
I64 = torch.int64

# int64 temporaries of one chunk of a device pass hold about this many
# elements (each chunk's int64 working set is a few times this in bytes).
# The prover's column, row and Merkle pair-level chunks all derive from it.
CHUNK_ELEMS = 1 << 28


def _l(x):
    """int64 view of a tensor (python ints pass through)."""
    return x.to(I64) if isinstance(x, torch.Tensor) else x


def mul(a, b):
    """Montgomery product a * b * R^-1 mod p (int32 out)."""
    return ((_l(a) * _l(b)) % P * RINV % P).to(I32)


def mul_std(a, s):
    """Montgomery a times standard-form s: the Montgomery form of a*s."""
    return ((_l(a) * _l(s)) % P).to(I32)


def add(a, b):
    d = a - (P - b)
    return torch.where(d < 0, d + P, d).to(I32)


def sub(a, b):
    d = a - b
    return torch.where(d < 0, d + P, d).to(I32)


def neg(a):
    return torch.where(a == 0, a, P - a).to(I32)


def to_monty(x):
    """Standard form -> Montgomery form (x * R mod p)."""
    return (_l(x) % P * R % P).to(I32)


def from_monty(a):
    """Montgomery form -> standard form (a * R^-1 mod p)."""
    return (_l(a) * RINV % P).to(I32)


def mont_one() -> int:
    """The Montgomery representation of 1 (a python int constant)."""
    return R


def pow_const(a, e: int):
    """a ** e for a static python exponent (square-and-multiply)."""
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    if result is None:
        return torch.full_like(a, R, dtype=I32)
    return result


def inv(a):
    """Multiplicative inverse via Fermat: a^(p-2). Montgomery in/out."""
    return pow_const(a, P - 2)


# ---------------------------------------------------------------------------
# Degree-4 extension: trailing axis of size 4, x^4 = BETA
# ---------------------------------------------------------------------------


def ext_from_base(a):
    """Embed a base-field tensor (...,) -> extension tensor (..., 4)."""
    z = torch.zeros(a.shape + (3,), dtype=I32, device=a.device)
    return torch.cat([a[..., None].to(I32), z], dim=-1)


ext_add = add
ext_sub = sub


def _mul_beta(a):
    return mul_std(a, BETA)


def ext_mul(a, b):
    """Schoolbook quartic multiply with x^4 = BETA reduction."""
    a0, a1, a2, a3 = (a[..., i] for i in range(4))
    b0, b1, b2, b3 = (b[..., i] for i in range(4))
    c0 = add(mul(a0, b0), _mul_beta(add(add(mul(a1, b3), mul(a2, b2)),
                                        mul(a3, b1))))
    c1 = add(add(mul(a0, b1), mul(a1, b0)),
             _mul_beta(add(mul(a2, b3), mul(a3, b2))))
    c2 = add(add(mul(a0, b2), mul(a1, b1)),
             add(mul(a2, b0), _mul_beta(mul(a3, b3))))
    c3 = add(add(mul(a0, b3), mul(a1, b2)), add(mul(a2, b1), mul(a3, b0)))
    return torch.stack([c0, c1, c2, c3], dim=-1)


def ext_mul_base(a, s):
    """Extension (..., 4) times a base-field tensor (...,)."""
    return mul(a, s[..., None])


def ext_inv(a):
    """Quartic inverse via the conjugate/norm trick (see zeth_tpu.field)."""
    a0, a1, a2, a3 = (a[..., i] for i in range(4))
    b0 = add(mul(a0, a0), _mul_beta(sub(mul(a2, a2), mul(add(a1, a1), a3))))
    b2 = sub(mul(add(a0, a0), a2), add(mul(a1, a1), _mul_beta(mul(a3, a3))))
    denom_inv = inv(sub(mul(b0, b0), _mul_beta(mul(b2, b2))))
    n0 = sub(mul(a0, b0), _mul_beta(mul(a2, b2)))
    n1 = sub(_mul_beta(mul(a3, b2)), mul(a1, b0))
    n2 = sub(mul(a2, b0), mul(a0, b2))
    n3 = sub(mul(a1, b2), mul(a3, b0))
    return ext_mul_base(torch.stack([n0, n1, n2, n3], dim=-1), denom_inv)


def ext_pow_const(a, e: int):
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else ext_mul(result, base)
        e >>= 1
        if e:
            base = ext_mul(base, base)
    if result is None:
        one = torch.zeros_like(a, dtype=I32)
        one[..., 0] = R
        return one
    return result
