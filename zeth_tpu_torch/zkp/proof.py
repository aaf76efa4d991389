"""Seal encoding: StarkProof <-> flat little-endian u32 words.

Jax-free copy of ``zeth_tpu.zkp.proof``: the port's seals have the same
words as the reference's for the same proof.

The reference's seals and zkVM inputs are word-aligned u32 vectors
(`to_zkvm_input_bytes`, the reference's crates/host/src/lib.rs:150-154);
this module gives the rebuilt framework the same convention: a proof is
a single flat ``np.uint32`` array ("seal"), suitable for hashing,
transport, and byte-exact size accounting.

Layout: a tiny tag/length-prefixed word stream (see Writer/Reader); all
field elements are standard form (< p), digests are 8 words.
"""

from __future__ import annotations

import numpy as np

from . import fri as fri_mod
from .fri import FriLayerOpening, FriProof
from .prover import GroupOpening, StarkProof

MAGIC = 0x7A657468  # "zeth"
VERSION = 1


class Writer:
    def __init__(self):
        self.words: list[int] = []

    def u32(self, v: int):
        assert 0 <= v < (1 << 32)
        self.words.append(int(v))

    def string(self, s: str):
        raw = s.encode()
        self.u32(len(raw))
        raw += b"\x00" * (-len(raw) % 4)
        self.words.extend(int(w) for w in np.frombuffer(raw, dtype="<u4"))

    def array(self, a: np.ndarray):
        a = np.asarray(a, dtype=np.uint64)
        self.u32(a.ndim)
        for d in a.shape:
            self.u32(d)
        self.words.extend(int(v) for v in a.reshape(-1))

    def finish(self) -> np.ndarray:
        return np.array(self.words, dtype=np.uint32)


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


def encode(proof: StarkProof) -> np.ndarray:
    w = Writer()
    w.u32(MAGIC)
    w.u32(VERSION)
    w.string(proof.air_name)
    w.u32(proof.po2)
    w.u32(len(proof.publics))
    for p in proof.publics:
        w.u32(int(p) & 0xFFFFFFFF)
    groups = ("control", "main", "aux", "check")
    for g in groups:
        present = g in proof.roots
        w.u32(1 if present else 0)
        if present:
            w.array(proof.roots[g])
    w.array(proof.taps)
    # FRI
    fp = proof.fri_proof
    w.u32(len(fp.layer_roots))
    for r in fp.layer_roots:
        w.array(r)
    w.array(fp.final_coeffs)
    w.u32(int(fp.pow_nonce) & 0xFFFFFFFF)
    w.u32(len(fp.openings))
    for per_layer in fp.openings:
        w.u32(len(per_layer))
        for op in per_layer:
            w.array(op.row)
            w.array(op.path)
    # group openings
    for g in groups:
        op = proof.openings.get(g)
        w.u32(1 if op is not None else 0)
        if op is not None:
            w.array(op.rows)
            w.u32(len(op.paths))
            for p in op.paths:
                w.array(p)
    w.u32(len(proof.query_indices))
    for q in proof.query_indices:
        w.u32(q)
    return w.finish()


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


def seal_size_words(proof: StarkProof) -> int:
    return int(encode(proof).shape[0])
