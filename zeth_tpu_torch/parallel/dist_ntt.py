"""Distributed NTT: Bailey's four-step over the ``rows`` dimension of a mesh.

Counterpart of ``zeth_tpu.parallel.dist_ntt``. With i = r*C + c,
k = k_r + R*k_c and w = w_n:

  X[k] = sum_c w^(c*k_r) * w_C^(c*k_c) * [ sum_r x[r,c] * w_R^(r*k_r) ]

so (a) an all_to_all takes each rank's row block of the (R, C) matrix to
a column block, (b) an R-point NTT runs down each local column, (c) each
element is scaled by w^(c*k_r) with the global column c = d*(C/D) +
local index, (d) an all_to_all takes the column blocks back to row
blocks (k_r), (e) a C-point NTT runs along each local k_r row, and (f) a
last all_to_all takes the (C, R) result, sharded on k_r, to contiguous
flat row blocks (element (k_c, k_r) is X[k_c*R + k_r]).

A tensor "row-block sharded" over D ranks is the (n/D, batch...) block
of rows [d*n/D, (d+1)*n/D) of the global (n, batch...) array on rank d.
Every transform here takes and returns that layout, in Montgomery form,
with the radix-2 ``ntt._ntt_core`` as its local transform; the only
communication is ``comm.all_to_all``.
"""

from __future__ import annotations

import torch

from .. import field as F
from .. import hostmath as H
from .. import ntt as ntt_mod
from ..hostmath import GENERATOR, P
from . import comm


def _split_rc(n: int) -> tuple[int, int]:
    """n = R*C with R, C as close to square as possible (both powers of 2)."""
    lg = n.bit_length() - 1
    lr = lg // 2
    return 1 << lr, 1 << (lg - lr)


def _check_shape(n: int, d: int) -> tuple[int, int]:
    r, c = _split_rc(n)
    if n & (n - 1) or r % d or c % d:
        raise ValueError(
            f"dist_ntt: {n} rows over {d} ranks; the four-step needs a power "
            f"of two n with R = {r} and C = {c} both divisible by the rank "
            f"count, so n >= D^2 = {d * d}")
    return r, c


def _twiddles(n: int, r: int, c: int, d: int, rank: int, inverse: bool,
              device):
    """(R, C/D) standard-form w^(c*k_r) for this rank's global columns
    c = rank*(C/D) + j (w = w_n, inverted for the inverse transform)."""
    w = H.rou_rev(n) if inverse else H.rou_fwd(n)
    key = ("dist_tw", n, inverse, d, rank)

    def make():
        kr = torch.arange(r, dtype=torch.int64)[:, None]
        col = rank * (c // d) + torch.arange(c // d, dtype=torch.int64)
        return (kr * col[None, :]) % n
    expo = ntt_mod._device_table(key, device, make)
    return ntt_mod.power_table(w, n, device)[expo]


def _dist_ntt(x, mesh, inverse: bool):
    """The four-step transform of a row-block-sharded (n/D, batch...)
    tensor (unscaled when `inverse`)."""
    d, rank = comm.size(mesh), comm.rank(mesh)
    n = x.shape[0] * d
    batch = tuple(x.shape[1:])
    r, c = _check_shape(n, d)
    ones = (1,) * len(batch)
    # (a) rows -> columns: send column block j of the local (R/D, C) rows
    # to rank j; receive every rank's rows of this rank's columns
    xl = x.reshape((r // d, d, c // d) + batch).transpose(0, 1)
    xl = comm.all_to_all(xl, mesh).reshape((r, c // d) + batch)
    # (b) R-point NTT down each local column
    xl = ntt_mod._ntt_core(xl, inverse=inverse)
    # (c) the twiddles w^(c*k_r) at the global columns
    tw = _twiddles(n, r, c, d, rank, inverse, x.device)
    xl = F.mul_std(xl, tw.view((r, c // d) + ones))
    # (d) columns -> rows (k_r): block j of the k_r axis goes to rank j
    xl = comm.all_to_all(xl.reshape((d, r // d, c // d) + batch), mesh)
    xl = xl.transpose(0, 1).reshape((r // d, c) + batch)
    # (e) C-point NTT along each local k_r row: (C, R/D, batch)
    xl = ntt_mod._ntt_core(xl.transpose(0, 1).contiguous(), inverse=inverse)
    # (f) the (C, R) result, sharded on k_r, to contiguous flat blocks of
    # k_c: block j of the k_c axis goes to rank j
    xl = comm.all_to_all(xl.reshape((d, c // d, r // d) + batch), mesh)
    return xl.transpose(0, 1).reshape((n // d,) + batch)


def dist_ntt(x, mesh):
    """Forward NTT over axis 0 of a row-block-sharded (n/D, batch...)
    tensor: this rank's rows of ``ntt.ntt`` of the global array."""
    return _dist_ntt(x, mesh, inverse=False)


def dist_intt(x, mesh):
    """Inverse NTT (the 1/n factor folded in)."""
    n = x.shape[0] * comm.size(mesh)
    return F.mul_std(_dist_ntt(x, mesh, inverse=True), pow(n, P - 2, P))


def dist_coset_lde(values, mesh, blowup: int = 4, shift: int = GENERATOR):
    """Distributed coset LDE: iNTT, the shift-power scale on this rank's
    slice of shift^i, zero-padding to blowup*n, then the NTT.

    values: row-block-sharded (n/D, batch...) Montgomery; returns this
    rank's (blowup*n/D, batch...) row block of ``ntt.coset_lde`` of the
    global array (``prover._lde`` word for word).

    The padded transform is taken as its `blowup` cosets: with c the
    shifted coefficients, row blowup*j + t of the blowup*n-point NTT of
    c padded with zeros is row j of the n-point NTT of c_i * w^(i*t)
    (w = w_{blowup*n}). Each coset's transform is row-block sharded like
    the coefficients, so rows blowup*j + t of this rank's block are its
    rows j of the `blowup` cosets, and no rank holds the padded array.
    """
    d, rank = comm.size(mesh), comm.rank(mesh)
    m = values.shape[0]
    n = m * d
    batch = tuple(values.shape[1:])
    ones = (1,) * len(batch)
    coeffs = dist_intt(values, mesh)
    lo = rank * m
    sp = ntt_mod.power_table(shift, n, values.device)[lo:lo + m]
    coeffs = F.mul_std(coeffs, sp.view((m,) + ones))
    w = H.rou_fwd(blowup * n)
    out = torch.empty((m, blowup) + batch, dtype=torch.int32,
                      device=values.device)
    for t in range(blowup):
        if t == 0:
            out[:, 0] = dist_ntt(coeffs, mesh)
            continue
        wt = ntt_mod.power_table(pow(w, t, P), n, values.device)[lo:lo + m]
        out[:, t] = dist_ntt(F.mul_std(coeffs, wt.view((m,) + ones)), mesh)
    return out.reshape((blowup * m,) + batch)
