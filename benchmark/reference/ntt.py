"""Frozen copy of ``zeth_tpu_torch/ntt.py`` (the radix-2 NTT in plain
torch, for the control group's LDE); the benchmark's yardstick, so it does not follow later
changes to the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import field as F
from . import hostmath as H
from .hostmath import P


@functools.lru_cache(maxsize=None)
def bitrev_perm(n: int) -> np.ndarray:
    """Bit-reversal permutation for size n = 2^k (numpy, host)."""
    k = n.bit_length() - 1
    assert 1 << k == n
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


_TABLES: dict = {}


def _device_table(key, device, make):
    """Per-device cache of small constant tensors built by make()."""
    k = (key, str(device))
    t = _TABLES.get(k)
    if t is None:
        t = make()
        t = tuple(x.to(device) for x in t) if isinstance(t, tuple) \
            else t.to(device)
        _TABLES[k] = t
    return t


def _stage_twiddles(n: int, inverse: bool, device):
    """Standard-form int64 twiddles w_m^j (j < m/2) for m = 2, 4, .., n."""
    def make():
        out = []
        for s in range(1, n.bit_length()):
            m = 1 << s
            w = H.rou_rev(m) if inverse else H.rou_fwd(m)
            out.append(torch.from_numpy(H.powers(w, m // 2).astype(np.int64)))
        return tuple(out)
    return _device_table(("tw", n, inverse), device, make)


def power_table(base: int, n: int, device):
    """[base^0 .. base^(n-1)] mod p, standard form, int64 tensor."""
    return _device_table(
        ("pow", base % P, n), device,
        lambda: torch.from_numpy(H.powers(base, n).astype(np.int64)))


def _ntt_core(x, inverse: bool):
    """DIT NTT over axis 0. Natural order in, natural order out."""
    n = x.shape[0]
    batch = tuple(x.shape[1:])
    ones = (1,) * len(batch)
    if n == 1:
        return x.clone()
    perm = _device_table(("bitrev", n), x.device,
                         lambda: torch.from_numpy(bitrev_perm(n)))
    x = x.index_select(0, perm)
    tws = _stage_twiddles(n, inverse, x.device)
    for s in range(1, n.bit_length()):
        m = 1 << s
        half = m // 2
        xr = x.view((n // m, m) + batch)
        even = xr[:, :half]
        odd = F.mul_std(xr[:, half:], tws[s - 1].view((1, half) + ones))
        x = torch.cat([F.add(even, odd), F.sub(even, odd)], dim=1)
        x = x.view((n,) + batch)
    return x


def ntt(x):
    """Coefficients -> evaluations on the size-n subgroup (natural order)."""
    return _ntt_core(x, inverse=False)


def intt(x):
    """Evaluations on the size-n subgroup -> coefficients."""
    n = x.shape[0]
    return F.mul_std(_ntt_core(x, inverse=True), pow(n, P - 2, P))
