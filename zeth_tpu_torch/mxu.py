"""Exact Baby Bear matrix products as int8 matrix products.

Counterpart of ``zeth_tpu.mxu``, on the GPU's int8 tensor cores where
the JAX package uses the TPU's systolic array:

  - every value < 2^31 is split into 4 signed base-256 digits
    d_i in [-128, 127] (int8), value = sum d_i 256^i;
  - a (m, k) x (k, n) field product becomes 16 int8 products with int32
    accumulation (``torch._int_mm``); each is bounded by k * 2^14, so k
    is chunked at 2^16 and the chunks' residues are added mod p;
  - the 7 digit-weighted partial sums recombine mod p.

A partial sum adds up to four such products in int32, as the reference
does. For digit columns near the -128 corner that sum passes 2^31 and
wraps; each partial is therefore reduced from the value an int32
accumulator holds (two's complement), so every result equals the
reference's word for word, wrap included. Operands that look random
(field values in Montgomery form, power rows, coefficients) stay far
below the limit.

Montgomery bookkeeping: with A in Montgomery form (aR) and B in standard
form (b), the integer dot recombines to R * sum(ab) mod p: the Montgomery
form of the standard product, with no fix-up. Every entry point below
uses that convention; results are Montgomery int32 tensors.

The four-step NTT (``ntt_fs``) and coset LDE (``coset_lde_fs``) run
their two small-matrix stages as such products; they equal
``ntt.ntt``/``ntt.intt``/``ntt.coset_lde`` bit for bit. The digit split,
the reductions, the twiddle scale and the interleave are plain torch.
There is no other path: a failing ``torch._int_mm`` raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as NF

from . import field as F
from . import hostmath as H
from .hostmath import GENERATOR, P
from .ntt import _device_table

# |d_i d_j| <= 2^14, so a length-k int32 dot is bounded by k * 2^14;
# k <= 2^16 keeps one dot at 2^30 (the reference's chunk)
_MAX_K = 1 << 16

# Montgomery constants (256^s << 32) % p: a Montgomery product by these
# gives the plain product r * 256^s mod p.
_POW256_M = tuple(((pow(256, s, P) << 32) % P) for s in range(7))

# digit transients are 4 int8 copies of each k-block of `a`; bound them
_BLOCK_BYTES = 1 << 28

# column block width: bounds the int8/int32 transients of one block
FS_COL_BLOCK = 128


def _digits_i8(x):
    """int32 tensor (values < 2^31 - 2^24) -> list of 4 int8 tensors,
    the signed base-256 digits, least significant first."""
    out = []
    cur = x.to(torch.int32)
    for _ in range(3):
        d = cur & 0xFF
        borrow = (d > 127).to(torch.int32)
        out.append((d - (borrow << 8)).to(torch.int8))
        cur = (cur >> 8) + borrow
    out.append(cur.to(torch.int8))
    return out


def _reduce_i32(s):
    """Exact integer sums (int64 or int32) -> the residue mod p, in
    [0, p) as int32, of the value an int32 accumulator holds for them
    (wrapped mod 2^32 into [-2^31, 2^31)): the reference's result."""
    s = s.to(torch.int64)
    w = ((s + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return torch.remainder(w, P).to(torch.int32)


def _recombine(partials):
    """partials[s] (integer sums) for s = 0..6 -> sum_s partials[s] *
    256^s mod p (int32)."""
    acc = _reduce_i32(partials[0])
    for s in range(1, 7):
        acc = F.add(acc, F.mul(_reduce_i32(partials[s]), _POW256_M[s]))
    return acc


def _mm_i8(a8, b8):
    """(m, k) int8 x (k, n) int8 -> (m, n) int32 through ``torch._int_mm``.

    On a CUDA card that call wants m > 16 and k, n multiples of 8; the
    operands are zero-padded to that (exact: padded rows and columns
    add nothing) on every device, so the CPU runs the same code."""
    m, k = a8.shape
    n = b8.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a8 = NF.pad(a8, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b8 = NF.pad(b8, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a8.contiguous(), b8.contiguous())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def _digit_products(da, db):
    """The 7 partial sums sum_{i+j=s} da[i] @ db[j] (int64) of two
    digit lists of GEMM-form (m, k) and (k, n) int8 matrices. All 16
    digit products come from one product of the stacked digit planes,
    (4m, k) x (k, 4n): with a short m and n and a long k (the streamed
    openings' 50 queries against 2^16 coefficient rows) one GEMM has 16
    times the output tiles of each small one."""
    m, n = da[0].shape[0], db[0].shape[1]
    out = _mm_i8(torch.cat(da, 0), torch.cat(db, 1))
    partials = [None] * 7
    for i in range(4):
        for j in range(4):
            p = out[i * m:(i + 1) * m, j * n:(j + 1) * n].to(torch.int64)
            s = i + j
            partials[s] = p if partials[s] is None else partials[s] + p
    return partials


def _modmm_block(a, b, ta: bool):
    """Integer-exact field product over one k-block (k <= _MAX_K): a
    (m, k) (or (k, m) when `ta`) x b (k, n) -> sum_k a*b mod p, int32 in
    [0, p)."""
    da = _digits_i8(a)
    if ta:
        da = [d.t().contiguous() for d in da]
    return _recombine(_digit_products(da, _digits_i8(b)))


def _modmm(a, b, ta: bool):
    """a (m, k) [or (k, m) when ta] x b (k, n) -> (m, n) mod p.

    k is chunked at _MAX_K for int32 exactness; m is chunked so the int8
    digit transients stay under _BLOCK_BYTES."""
    if ta:
        k, m = a.shape
    else:
        m, k = a.shape
    n = b.shape[1]
    kc = max(1, min(k, _MAX_K))
    mc = m
    if m * kc * 4 > _BLOCK_BYTES:
        mc = max(256, _BLOCK_BYTES // (kc * 4))
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    for moff in range(0, m, mc):
        me = min(m, moff + mc)
        acc = None
        for off in range(0, k, kc):
            ke = min(k, off + kc)
            ablk = a[off:ke, moff:me] if ta else a[moff:me, off:ke]
            blk = _modmm_block(ablk, b[off:ke], ta)
            acc = blk if acc is None else F.add(acc, blk)
        if acc is None:
            acc = torch.zeros((me - moff, n), dtype=torch.int32,
                              device=a.device)
        out[moff:me] = acc
    return out


def modmm(a, b):
    """Field product (m, k) x (k, n) -> (m, n), exact mod p.

    Typical use: a = Montgomery-form columns, b = standard-form weights
    -> Montgomery-form weighted sums (or the other way round: the
    integer dot is symmetric)."""
    return _modmm(a, b, False)


def modmm_tn(a, b):
    """Transposed-contraction field product: (k, m)^T x (k, n) -> (m, n);
    contracts the leading axis of both operands."""
    return _modmm(a, b, True)


def modmm_plain(a, b):
    """The plain version of ``modmm``: int64 products, each reduced mod
    p, summed over k-chunks of a bounded (m, chunk, n) int64 temporary.
    The tests hold ``modmm`` against it."""
    m, k = a.shape
    n = b.shape[1]
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    acc = torch.zeros((m, n), dtype=torch.int64, device=a.device)
    chunk = max(1, F.CHUNK_ELEMS // 8 // max(m * n, 1))
    for off in range(0, k, chunk):
        t = a64[:, off:off + chunk, None] * b64[None, off:off + chunk, :]
        acc = torch.remainder(acc + torch.remainder(t, P).sum(dim=1), P)
    return acc.to(torch.int32)


# ---------------------------------------------------------------------------
# Four-step NTT
# ---------------------------------------------------------------------------
#
# An order-N NTT splits as N = n1*n2 (j = j1*n2 + j2, k = k2*n1 + k1):
#
#   X[k2*n1 + k1] = sum_j2 w_N^(k1 j2) w_n2^(k2 j2)
#                     * ( sum_j1 x[j1*n2 + j2] w_n1^(k1 j1) )
#
# two batched small-matrix products (W1: n1 x n1, W2: n2 x n2) around one
# elementwise twiddle. The W matrices are standard form and the data
# Montgomery, so each product returns the Montgomery form of the plain
# transform. The inverse folds 1/N into W2.


def _digits_i8_np(vals: np.ndarray) -> np.ndarray:
    """Host digit split: uint array < 2^31-2^24 -> (4, ...) int8."""
    out = np.zeros((4,) + vals.shape, np.int8)
    cur = vals.astype(np.int64)
    for i in range(3):
        d = cur & 0xFF
        borrow = d > 127
        d = d - (borrow.astype(np.int64) << 8)
        cur = (cur >> 8) + borrow
        out[i] = d.astype(np.int8)
    out[3] = cur.astype(np.int8)
    return out


@functools.lru_cache(maxsize=None)
def _split_n(n: int) -> tuple[int, int]:
    k = n.bit_length() - 1
    n1 = 1 << ((k + 1) // 2)
    return n1, n // n1


@functools.lru_cache(maxsize=None)
def _w_digits(m: int, inverse: bool, scale: int) -> np.ndarray:
    """(4, m, m) int8 digits of W[k, j] = scale * w_m^(+-kj) (std form)."""
    w = H.rou_rev(m) if inverse else H.rou_fwd(m)
    rows = [H.powers(pow(int(w), k, P), m) * np.uint64(scale % P)
            % np.uint64(P) for k in range(m)]
    return _digits_i8_np(np.stack(rows, axis=0))


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, inverse: bool) -> np.ndarray:
    """(n1, n2) standard-form w_N^(+-k1 j2) twiddle table (the data is
    scaled by ``field.mul_std``, one reduction per product)."""
    n1, n2 = _split_n(n)
    w = H.rou_rev(n) if inverse else H.rou_fwd(n)
    return np.stack([H.powers(pow(int(w), k1, P), n2) for k1 in range(n1)],
                    axis=0).astype(np.int64)


def _w_dev(m: int, inverse: bool, scale: int, device):
    return _device_table(
        ("mxu_w", m, inverse, scale), device,
        lambda: torch.from_numpy(_w_digits(m, inverse, scale)))


def _mm_digits(dw, da, dn_a: int):
    """Exact mod-p product of a constant digit matrix against digitized
    data: dw (4, m, m) int8, da a list of 4 int8 tensors whose axis
    `dn_a` has length m. Returns an int32 mod-p tensor shaped like da
    with axis dn_a replaced by the W row axis, moved to the front."""
    shape = tuple(da[0].shape)
    m = shape[dn_a]
    rest = shape[:dn_a] + shape[dn_a + 1:]
    flat = [d.movedim(dn_a, 0).reshape(m, -1) for d in da]
    acc = None
    for s in range(7):
        part = None
        for i in range(max(0, s - 3), min(3, s) + 1):
            prod = _mm_i8(dw[i], flat[s - i]).to(torch.int64)
            part = prod if part is None else part + prod
        r = _reduce_i32(part)
        del part
        if s:
            r = F.mul(r, _POW256_M[s])
        acc = r if acc is None else F.add(acc, r)
    return acc.reshape((dw.shape[1],) + rest)


def _ntt_fs_block(x, n: int, inverse: bool, scale_n: bool):
    """Four-step NTT of one column block: x (n, C) Montgomery -> (n, C)
    Montgomery, natural order in and out."""
    n1, n2 = _split_n(n)
    C = x.shape[1]
    dev = x.device
    da = _digits_i8(x.reshape(n1, n2, C))
    # step 1: contract j1 -> (k1, n2, C)
    b = _mm_digits(_w_dev(n1, inverse, 1, dev), da, 0)
    del da
    # step 2: twiddle w_N^(k1 j2)
    tw = _device_table(("mxu_tw", n, inverse), dev,
                       lambda: torch.from_numpy(_twiddles(n, inverse)))
    b = F.mul_std(b, tw[:, :, None])
    # step 3: contract j2 -> (k2, k1, C); folding 1/n into W2 makes the
    # inverse transform come out scaled
    db = _digits_i8(b)
    del b
    scale = pow(n, P - 2, P) if scale_n else 1
    out = _mm_digits(_w_dev(n2, inverse, scale, dev), db, 1)
    return out.reshape(n, C)


def ntt_fs(x_monty, inverse: bool = False):
    """(n, C) Montgomery NTT (or iNTT) by column-blocked four-step
    products. Bit-identical to ``ntt.ntt`` / ``ntt.intt``."""
    n, C = x_monty.shape
    out = torch.empty((n, C), dtype=torch.int32, device=x_monty.device)
    for off in range(0, C, FS_COL_BLOCK):
        out[:, off:off + FS_COL_BLOCK] = _ntt_fs_block(
            x_monty[:, off:off + FS_COL_BLOCK], n, inverse, inverse)
    return out


@functools.lru_cache(maxsize=None)
def _coset_scales(n: int, blowup: int, shift: int) -> np.ndarray:
    """(blowup, n) standard-form tables (shift * w_{blowup*n}^r)^i: the
    per-coset coefficient pre-scales of the interleaved LDE."""
    w = H.rou_fwd(blowup * n)
    return np.stack([H.powers(int(shift) * pow(int(w), r, P) % P, n)
                     for r in range(blowup)], axis=0).astype(np.int64)


def _lde_fs_block(x, out4, n: int, blowup: int, shift: int):
    """Coset LDE of one column block: x (n, C) Montgomery evaluations on
    <w_n> -> evaluations on shift*<w_{blowup*n}>, written into out4, an
    (n, blowup, C) view of the natural-order (blowup*n, C) result: coset
    r is rows blowup*k + r. Runs blowup size-n forward transforms."""
    coeffs = _ntt_fs_block(x, n, True, True)
    scales = _device_table(
        ("mxu_cs", n, blowup, shift), x.device,
        lambda: torch.from_numpy(_coset_scales(n, blowup, shift)))
    for r in range(blowup):
        out4[:, r] = _ntt_fs_block(F.mul_std(coeffs, scales[r][:, None]), n,
                                   False, False)


def coset_lde_fs(values_monty, blowup: int = 4, shift: int = None):
    """Four-step coset LDE, column-blocked: (n, C) Montgomery evaluations
    -> (blowup*n, C) on shift*<w_{blowup*n}> (default shift: the
    generator 31). Bit-identical to ``ntt.coset_lde``."""
    if shift is None:
        shift = GENERATOR
    n, C = values_monty.shape
    out = torch.empty((blowup * n, C), dtype=torch.int32,
                      device=values_monty.device)
    for off in range(0, C, FS_COL_BLOCK):
        blk = values_monty[:, off:off + FS_COL_BLOCK]
        w = blk.shape[1]
        _lde_fs_block(blk, out[:, off:off + w].view(n, blowup, w), n,
                      blowup, shift)
    return out
