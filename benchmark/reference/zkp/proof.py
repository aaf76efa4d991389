"""Frozen copy of ``zeth_tpu_torch/zkp/proof.py`` (the seal decoder); the benchmark's yardstick, so it does not follow later
changes to the program.
"""

from __future__ import annotations

import numpy as np

from . import fri as fri_mod
from .fri import FriLayerOpening, FriProof
from .stark import GroupOpening, StarkProof


MAGIC = 0x7A657468  # "zeth"
VERSION = 1


class Reader:
    def __init__(self, seal: np.ndarray):
        self.w = np.asarray(seal, dtype=np.uint32)
        self.pos = 0

    def u32(self) -> int:
        if self.pos >= self.w.shape[0]:
            raise ValueError("seal truncated")
        v = int(self.w[self.pos])
        self.pos += 1
        return v

    def string(self) -> str:
        nbytes = self.u32()
        nwords = (nbytes + 3) // 4
        if nwords > self.w.shape[0] - self.pos:
            raise ValueError("seal truncated")
        raw = self.w[self.pos:self.pos + nwords].astype("<u4").tobytes()
        self.pos += nwords
        return raw[:nbytes].decode()

    def array(self) -> np.ndarray:
        ndim = self.u32()
        if ndim > 4:
            raise ValueError("seal array rank too large")
        shape = tuple(self.u32() for _ in range(ndim))
        count = int(np.prod(shape)) if shape else 1
        if count > self.w.shape[0] - self.pos:
            raise ValueError("seal array exceeds seal length")
        flat = self.w[self.pos:self.pos + count].astype(np.uint64)
        self.pos += count
        return flat.reshape(shape)


def decode(seal: np.ndarray) -> StarkProof:
    r = Reader(seal)
    assert r.u32() == MAGIC, "bad seal magic"
    assert r.u32() == VERSION, "bad seal version"
    air_name = r.string()
    po2 = r.u32()
    publics = [r.u32() for _ in range(r.u32())]
    groups = ("control", "main", "aux", "check")
    roots = {}
    for g in groups:
        if r.u32():
            roots[g] = r.array()
    taps = r.array()
    n_layers = r.u32()
    if n_layers > 16:
        raise ValueError("seal: too many FRI layers")
    layer_roots = [r.array() for _ in range(n_layers)]
    final_coeffs = r.array()
    pow_nonce = r.u32()
    n_open = r.u32()
    if n_open != fri_mod.QUERIES:
        raise ValueError("seal: bad FRI opening count")
    openings = []
    for _ in range(n_open):
        per_layer = []
        n_per = r.u32()
        if n_per != n_layers:
            raise ValueError("seal: bad per-query layer count")
        for _ in range(n_per):
            row = r.array()
            path = r.array()
            per_layer.append(FriLayerOpening(row=row, path=path))
        openings.append(per_layer)
    fp = FriProof(layer_roots=layer_roots, final_coeffs=final_coeffs,
                  openings=openings, pow_nonce=pow_nonce)
    group_ops = {}
    for g in groups:
        if r.u32():
            rows = r.array()
            paths = [r.array() for _ in range(r.u32())]
            group_ops[g] = GroupOpening(rows=rows, paths=paths)
    qs = [r.u32() for _ in range(r.u32())]
    return StarkProof(air_name=air_name, po2=po2, publics=publics,
                      roots=roots, taps=taps, fri_proof=fp,
                      openings=group_ops, query_indices=qs)
