"""EIP-4844 KZG point-evaluation (precompile 0x0a) over BLS12-381.

Implements the consensus-specs `verify_kzg_proof` and the execution
layer precompile semantics (input layout, versioned-hash check, fixed
output) used by revm's c-kzg path in the reference (SURVEY.md §2.2,
guests/stateless-client/Cargo.toml c-kzg/blst patches).

Trusted setup: verification needs ONE ceremony point, [tau]_2 from the
Ethereum KZG ceremony (`trusted_setup.json` g2_monomial[1]). This
environment has no network egress to fetch the ceremony artifact, so
the point is provisioned at runtime: `set_setup_g2()` or env
`ZETH_KZG_SETUP_G2` (96-byte compressed hex). Without it, blocks whose
transactions call 0x0a fail validation with a clear provisioning error
(they cannot be validated correctly without the ceremony constant).
Tests generate a local tau to exercise the full verification path.
"""

from __future__ import annotations

import hashlib
import os

from . import bls12381 as B

FIELD_ELEMENTS_PER_BLOB = 4096
BLS_MODULUS = B.R
VERSIONED_HASH_VERSION_KZG = 0x01
POINT_EVALUATION_GAS = 50000

# success output: U256(FIELD_ELEMENTS_PER_BLOB) ++ U256(BLS_MODULUS)
PRECOMPILE_OUTPUT = (FIELD_ELEMENTS_PER_BLOB.to_bytes(32, "big")
                     + BLS_MODULUS.to_bytes(32, "big"))

_SETUP_G2 = None


class KzgError(Exception):
    pass


def sqrt_fp2(a):
    """Square root in Fp2 (norm-based; p = 3 mod 4), or None."""
    a0, a1 = a
    if a1 == 0:
        r = B.sqrt_fp(a0)
        if r is not None:
            return (r, 0)
        r = B.sqrt_fp((-a0) % B.P)
        return None if r is None else (0, r)
    alpha = B.sqrt_fp((a0 * a0 + a1 * a1) % B.P)
    if alpha is None:
        return None
    inv2 = pow(2, B.P - 2, B.P)
    delta = (a0 + alpha) * inv2 % B.P
    x0 = B.sqrt_fp(delta)
    if x0 is None:
        delta = (a0 - alpha) * inv2 % B.P
        x0 = B.sqrt_fp(delta)
        if x0 is None:
            return None
    x1 = a1 * pow(2 * x0, B.P - 2, B.P) % B.P
    out = (x0, x1)
    return out if B.f2_mul(out, out) == (a0 % B.P, a1 % B.P) else None


def _f2_lex_gt_neg(y) -> bool:
    """Zcash sign convention: y lexicographically greater than -y,
    comparing (c1, c0)."""
    ny = B.f2_neg(y)
    return (y[1], y[0]) > (ny[1], ny[0])


def g2_decompress(data: bytes):
    """96-byte compressed G2 point (Zcash format: x_c1 || x_c0 with
    flags in the first byte) -> affine tuple / None. Raises KzgError."""
    if len(data) != 96:
        raise KzgError("bad g2 length")
    flags = data[0] >> 5
    c_flag, i_flag, s_flag = (flags >> 2) & 1, (flags >> 1) & 1, flags & 1
    if not c_flag:
        raise KzgError("uncompressed g2 not accepted")
    x_c1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x_c0 = int.from_bytes(data[48:96], "big")
    if i_flag:
        if x_c0 or x_c1 or s_flag:
            raise KzgError("bad g2 infinity encoding")
        return None
    if x_c0 >= B.P or x_c1 >= B.P:
        raise KzgError("g2 x out of range")
    x = (x_c0, x_c1)
    y = sqrt_fp2(B.f2_add(B.f2_mul(B.f2_mul(x, x), x), B.B2))
    if y is None:
        raise KzgError("g2 x not on curve")
    if _f2_lex_gt_neg(y) != bool(s_flag):
        y = B.f2_neg(y)
    pt = (x, y)
    if not B.g2_in_subgroup(pt):
        raise KzgError("g2 point not in subgroup")
    return pt


def set_setup_g2(point_or_bytes) -> None:
    """Provision [tau]_2 from the KZG ceremony (96-byte compressed or an
    affine tuple)."""
    global _SETUP_G2
    if isinstance(point_or_bytes, (bytes, bytearray)):
        _SETUP_G2 = g2_decompress(bytes(point_or_bytes))
    else:
        pt = point_or_bytes
        if not (B.g2_valid(pt) and B.g2_in_subgroup(pt)):
            raise KzgError("setup point invalid")
        _SETUP_G2 = pt


def setup_g2():
    global _SETUP_G2
    if _SETUP_G2 is None:
        env = os.environ.get("ZETH_KZG_SETUP_G2")
        if env:
            set_setup_g2(bytes.fromhex(env.removeprefix("0x")))
    return _SETUP_G2


def verify_kzg_proof(commitment: bytes, z: int, y: int,
                     proof: bytes) -> bool:
    """consensus-specs verify_kzg_proof:
    e(C - [y]_1, [1]_2) == e(W, [tau - z]_2)."""
    s2 = setup_g2()
    if s2 is None:
        raise KzgError(
            "KZG trusted setup not provisioned: set ZETH_KZG_SETUP_G2 "
            "to the ceremony's g2_monomial[1] (96-byte compressed hex) "
            "or call zeth_tpu_torch.app.kzg.set_setup_g2()")
    try:
        c_pt = B.g1_decompress(commitment)
        w_pt = B.g1_decompress(proof)
    except ValueError as e:
        raise KzgError(str(e)) from e
    if z >= BLS_MODULUS or y >= BLS_MODULUS:
        raise KzgError("field element out of range")
    # X - z in G2, against the generator side C - y*G1
    x_minus_z = g2_sub(s2, B.g2_mul(B.G2_GEN, z))
    c_minus_y = B.g1_add(c_pt, B.g1_neg(B.g1_mul(B.G1_GEN, y)))
    # e(C - y G1, -G2) * e(W, X - z G2) == 1
    return B.pairing_check([
        (c_minus_y, B.g2_neg(B.G2_GEN)),
        (w_pt, x_minus_z),
    ])


def g2_sub(a, b):
    return B.g2_add(a, B.g2_neg(b))


def point_evaluation(input_bytes: bytes) -> bytes:
    """The 0x0a precompile body. Returns the 64-byte output or raises
    KzgError (precompile failure)."""
    if len(input_bytes) != 192:
        raise KzgError("input must be 192 bytes")
    versioned_hash = input_bytes[0:32]
    z = int.from_bytes(input_bytes[32:64], "big")
    y = int.from_bytes(input_bytes[64:96], "big")
    commitment = input_bytes[96:144]
    proof = input_bytes[144:192]
    want = bytes([VERSIONED_HASH_VERSION_KZG]) \
        + hashlib.sha256(commitment).digest()[1:]
    if versioned_hash != want:
        raise KzgError("versioned hash mismatch")
    if not verify_kzg_proof(commitment, z, y, proof):
        raise KzgError("kzg proof invalid")
    return PRECOMPILE_OUTPUT


# -- local test setup ----------------------------------------------------------


def dev_setup(tau: int):
    """A locally generated tau setup for tests/benchmarks (INSECURE):
    returns ([tau^i]_1 list for commitments, and installs [tau]_2)."""
    set_setup_g2(B.g2_mul(B.G2_GEN, tau))
    return tau


def g1_compress(pt) -> bytes:
    """Compress an affine G1 point to the 48-byte wire format."""
    if pt is None:
        return bytes([0xC0]) + bytes(47)
    x, y = pt
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80
    if y > B.P - y:
        out[0] |= 0x20
    return bytes(out)
