"""Program builder for the recursion VM (recursion/vm.py).

A small straight-line DSL: values are WOM cell handles (ints); every
emitted row appends to the program arrays. The compiler
(recursion/compiler.py) uses this to express the full STARK verifier;
unit tests drive it directly with tiny hand programs.

Conventions:
- cell ONE (addr 0) holds 1 and ZERO (addr 1) holds 0, written by two
  bootstrap const rows;
- T_IN/T_BIT cells are base-field by constraint; FMA outputs are full
  F_p4; Poseidon digests are base by the DIG write constraint;
- the builder asserts reads-after-write order, so the dataflow graph of
  any built program is a DAG (WOM soundness precondition).

Port note: a jax-free copy of ``zeth_tpu.recursion.builder`` on the port's
Poseidon2 constants and host ``Transcript``; it emits the same programs
(``Program.digest()``), which the tests hold equal.
"""

from __future__ import annotations

import numpy as np

from ..hash import poseidon2 as P2
from ..hostmath import P
from .vm import (CELLS, N_PUB, N_SLOTS, Program, T_ABSHI, T_ABSLO, T_ASSERT,
                 T_BIT, T_DIG, T_DIGHI, T_FMA, T_IN, T_INIT, T_NOP, T_PUB,
                 T_REXT, T_RINT, T_SEL0, T_SEL4, WF_BITOF, WF_COMPOF,
                 WF_EXTINV, WF_INV, WF_STREAM)


def _ext4(x) -> tuple:
    if isinstance(x, (int, np.integer)):
        return (int(x) % P, 0, 0, 0)
    t = tuple(int(v) % P for v in x)
    assert len(t) == 4
    return t


class Builder:
    def __init__(self):
        self.typ: list[int] = []
        self.addr: list[list[int]] = []
        self.mult_slot: list[list[int]] = []   # 1 read / -1 write / 0
        self.rc: list[list[int]] = []
        self.s: list[list[int]] = []
        self.pub: list[int] = []
        self.wf: list[list[int]] = []
        self.n_cells = 0
        self.n_stream = 0
        self._written: list[bool] = []
        self._reads: list[int] = []
        self._write_row_slot: list[tuple] = []
        self._const_cache: dict = {}
        self.ONE = self.const(1)
        self.ZERO = self.const(0)
        self._ebasis = None

    # -- low-level row emission -------------------------------------------

    def _cell(self) -> int:
        self.n_cells += 1
        self._written.append(False)
        self._reads.append(0)
        self._write_row_slot.append(None)
        return self.n_cells - 1

    def _row(self, typ, addr=(), mult=(), rc=(), s=(), pub=-1, wf=(0, 0, 0)):
        a = [0] * N_SLOTS
        m = [0] * N_SLOTS
        for i, x in enumerate(addr):
            a[i] = int(x)
        for i, x in enumerate(mult):
            m[i] = int(x)
        r = [0] * CELLS
        for i, x in enumerate(rc):
            r[i] = int(x) % P
        sv = [0, 0, 0]
        for i, x in enumerate(s):
            sv[i] = int(x) % P
        row = len(self.typ)
        self.typ.append(typ)
        self.addr.append(a)
        self.mult_slot.append(m)
        self.rc.append(r)
        self.s.append(sv)
        self.pub.append(pub)
        self.wf.append(list(wf))
        for slot in range(N_SLOTS):
            if m[slot] == 1:          # read
                assert self._written[a[slot]], \
                    f"row {row}: read of unwritten cell {a[slot]}"
                self._reads[a[slot]] += 1
            elif m[slot] == -1:       # write
                assert not self._written[a[slot]], \
                    f"row {row}: double write of cell {a[slot]}"
                self._written[a[slot]] = True
                self._write_row_slot[a[slot]] = (row, slot)
        return row

    # -- arithmetic -------------------------------------------------------

    def fma(self, a=None, b=None, c=None, d=None, e=None,
            s0=0, s1=0, s2=0, imm=0) -> int:
        """out = s0*(a*b) + s1*(c*d) + s2*e + imm  (F_p4). Unused operand
        slots read ONE with multiplicity 0 (their values are unconstrained
        but also unused since the matching scalar is 0)."""
        out = self._cell()
        ops = [a, b, c, d, e]
        addr = [(x if x is not None else 0) for x in ops] + [out]
        mult = [0] * N_SLOTS
        used = [s0 != 0, s0 != 0, s1 != 0, s1 != 0, s2 != 0]
        for i, u in enumerate(used):
            if u:
                assert ops[i] is not None, f"operand {i} required"
                mult[i] = 1
        mult[5] = -1
        self._row(T_FMA, addr=addr, mult=mult, rc=_ext4(imm),
                  s=(s0 % P, s1 % P, s2 % P))
        return out

    def const(self, x) -> int:
        key = _ext4(x)
        c = self._const_cache.get(key)
        if c is None:
            c = self.fma(imm=key)
            self._const_cache[key] = c
        return c

    def add(self, a, b) -> int:
        return self.fma(a=a, b=self.ONE, c=b, d=self.ONE, s0=1, s1=1)

    def sub(self, a, b) -> int:
        return self.fma(a=a, b=self.ONE, c=b, d=self.ONE, s0=1, s1=P - 1)

    def mul(self, a, b) -> int:
        return self.fma(a=a, b=b, s0=1)

    def scale(self, a, k, imm=0) -> int:
        """k*a + imm for a compile-time scalar k."""
        return self.fma(a=a, b=self.ONE, s0=int(k) % P, imm=imm)

    def axpy(self, k, a, y) -> int:
        """k*a + y (scalar k)."""
        return self.fma(a=a, b=self.ONE, c=y, d=self.ONE,
                        s0=int(k) % P, s1=1)

    def muladd(self, a, b, y) -> int:
        """a*b + y."""
        return self.fma(a=a, b=b, e=y, s0=1, s2=1)

    def mulsub(self, y, a, b) -> int:
        """y - a*b."""
        return self.fma(a=a, b=b, e=y, s0=P - 1, s2=1)

    def select(self, bit, x, y) -> int:
        """bit ? x : y  (bit must be a 0/1 cell)."""
        diff = self.sub(x, y)
        return self.fma(a=bit, b=diff, e=y, s0=1, s2=1)

    def dot_const(self, coeffs, cells, imm=0) -> int:
        """sum_i coeffs[i]*cells[i] + imm (compile-time coeffs), as a
        chain of 2-term FMAs."""
        acc = None
        pairs = [(int(k) % P, c) for k, c in zip(coeffs, cells) if k % P]
        if not pairs:
            return self.const(imm)
        for i in range(0, len(pairs), 2):
            chunk = pairs[i:i + 2]
            if len(chunk) == 2:
                (k0, c0), (k1, c1) = chunk
                acc = self.fma(a=c0, b=self.ONE, c=c1, d=self.ONE, e=acc,
                               s0=k0, s1=k1, s2=0 if acc is None else 1,
                               imm=imm if i == 0 else 0)
            else:
                k0, c0 = chunk[0]
                acc = self.fma(a=c0, b=self.ONE, e=acc, s0=k0,
                               s2=0 if acc is None else 1,
                               imm=imm if i == 0 else 0)
        return acc

    # -- witness inputs ---------------------------------------------------

    def input(self) -> int:
        """Next base-field element of the witness stream."""
        out = self._cell()
        addr = [self.ONE] * 5 + [out]
        self._row(T_IN, addr=addr, mult=[0] * 5 + [-1],
                  wf=(WF_STREAM, 0, 0))
        self.n_stream += 1
        return out

    def inputs(self, k: int) -> list[int]:
        return [self.input() for _ in range(k)]

    def input_ext(self) -> int:
        """One F_p4 value from 4 stream elements (hashable components)."""
        c = self.inputs(4)
        return self.combine_ext(c)

    def combine_ext(self, comps: list[int]) -> int:
        """(c0,c1,c2,c3) base cells -> one ext cell."""
        e1, e2, e3 = self._ext_basis()
        t = self.fma(a=comps[1], b=e1, c=comps[2], d=e2, s0=1, s1=1)
        return self.fma(a=comps[3], b=e3, c=comps[0], d=self.ONE, e=t,
                        s0=1, s1=1, s2=1)

    def _ext_basis(self):
        if self._ebasis is None:
            self._ebasis = (self.const((0, 1, 0, 0)),
                            self.const((0, 0, 1, 0)),
                            self.const((0, 0, 0, 1)))
        return self._ebasis

    def bit_of(self, src: int, k: int) -> int:
        """Committed bit k of m[src] (to be bound via assert_bits)."""
        out = self._cell()
        addr = [self.ONE] * 5 + [out]
        self._row(T_BIT, addr=addr, mult=[0] * 5 + [-1],
                  wf=(WF_BITOF, src, k))
        return out

    def ext_components(self, x) -> list[int]:
        """Committed base components of ext cell x, bound by recombination
        (basis decomposition is unique since each component is < p)."""
        comps = []
        for c in range(4):
            out = self._cell()
            addr = [0] * 5 + [out]
            self._row(T_IN, addr=addr, mult=[0] * 5 + [-1],
                      wf=(WF_COMPOF, x, c))
            comps.append(out)
        self.assert_cells_eq(self.combine_ext(comps), x)
        return comps

    def inv(self, x) -> int:
        """1/x over F_p4 (witness + product check)."""
        comps = []
        for c in range(4):
            out = self._cell()
            addr = [self.ONE] * 5 + [out]
            self._row(T_IN, addr=addr, mult=[0] * 5 + [-1],
                      wf=(WF_EXTINV, x, c))
            comps.append(out)
        e = self.combine_ext(comps)
        self.assert_eq(self.mul(x, e), 1)
        return e

    # -- assertions / publics ---------------------------------------------

    def assert_eq(self, a, imm) -> None:
        self._row(T_ASSERT, addr=[a], mult=[1], rc=_ext4(imm))

    def assert_zero(self, a) -> None:
        self.assert_eq(a, 0)

    def assert_cells_eq(self, a, b) -> None:
        self.assert_zero(self.sub(a, b))

    def bind_public(self, a, j: int) -> None:
        assert 0 <= j < N_PUB
        self._row(T_PUB, addr=[a], mult=[1], pub=j)

    def decompose(self, x, nbits: int = 31, assert_canonical: bool = True
                  ) -> list[int]:
        """x -> nbits committed bits, sum-bound; for nbits=31 also assert
        the decomposition is the canonical one (< p)."""
        bits = [self.bit_of(x, k) for k in range(nbits)]
        self.assert_zero(self.fma(
            a=self.dot_const([1 << k for k in range(nbits)], bits),
            b=self.ONE, c=x, d=self.ONE, s0=1, s1=P - 1))
        if assert_canonical:
            assert nbits == 31
            nib = self.mul(self.mul(bits[27], bits[28]),
                           self.mul(bits[29], bits[30]))
            low = self.dot_const([1 << k for k in range(27)], bits[:27])
            self.assert_zero(self.mul(nib, low))
        return bits

    def pack_bits(self, bits: list[int], shift: int = 0) -> int:
        return self.dot_const([1 << (k + shift) for k in range(len(bits))],
                              bits)

    def pow_from_bits(self, base: int, bits: list[int]) -> int:
        """base^(sum 2^k b_k) for a compile-time base and bit cells."""
        acc = None
        w = int(base) % P
        for b in bits:
            f = self.fma(a=b, b=self.ONE, s0=(w - 1) % P, imm=1)  # b?w:1
            acc = f if acc is None else self.mul(acc, f)
            w = w * w % P
        return acc if acc is not None else self.ONE

    # -- Poseidon2 blocks -------------------------------------------------

    def _round_rows(self, init_rc=()):
        c = P2.constants()
        rc_ext, rc_int = c["rc_ext"], c["rc_int"]
        self._row(T_INIT, rc=init_rc)
        for r in range(4):
            self._row(T_REXT, rc=[int(v) for v in rc_ext[r]])
        for k in range(3):
            self._row(T_RINT, rc=[int(v) for v in rc_int[7 * k:7 * k + 7]])
        for r in range(4, 8):
            self._row(T_REXT, rc=[int(v) for v in rc_ext[r]])

    def _digest_rows(self, hi: bool = False) -> list[int]:
        cells = [self._cell() for _ in range(8)]
        self._row(T_DIG, addr=cells, mult=[-1] * 8)
        if hi:
            hi_cells = [self._cell() for _ in range(8)]
            self._row(T_DIGHI, addr=hi_cells, mult=[-1] * 8)
            return cells + hi_cells
        return cells

    def _absorb(self, chunk: list[int], fresh: bool, rc=()):
        lo = chunk[:8] + [self.ZERO] * (8 - len(chunk[:8]))
        self._row(T_ABSLO, addr=lo, mult=[1] * 8, rc=rc,
                  wf=(0, 0, 1 if fresh else 0))
        if len(chunk) > 8:
            hi = chunk[8:] + [self.ZERO] * (8 - len(chunk[8:]))
            self._row(T_ABSHI, addr=hi, mult=[1] * 8,
                      wf=(0, 0, 0))

    def sponge_hash(self, cells: list[int]) -> list[int]:
        """Poseidon2 sponge over base cells -> 8 digest cells. Matches
        hash_rows_np on the cells' c0 components."""
        cells = list(cells) or [self.ZERO]
        first = True
        for off in range(0, len(cells), P2.RATE):
            self._absorb(cells[off:off + P2.RATE], fresh=first)
            self._round_rows()
            first = False
        return self._digest_rows()

    def pair_hash(self, left8: list[int], right8: list[int]) -> list[int]:
        """hash_pairs_np equivalent (domain-separated 2-to-1)."""
        self._absorb(list(left8) + list(right8), fresh=True)
        tag = [0] * CELLS
        tag[2 * P2.DIGEST_LEN] = P2.PAIR_TAG
        self._round_rows(init_rc=tag)
        return self._digest_rows()

    def pair_hash_sel(self, bit, cur8, sib8) -> list[int]:
        """hash_pairs(bit ? (sib,cur) : (cur,sib)) — one Merkle level."""
        self._row(T_SEL0, addr=list(cur8[:4]) + list(sib8[:4]) + [bit],
                  mult=[1] * 9, wf=(0, 0, 1))
        self._row(T_SEL4, addr=list(cur8[4:8]) + list(sib8[4:8]) + [bit],
                  mult=[1] * 9, wf=(0, 0, 0))
        tag = [0] * CELLS
        tag[2 * P2.DIGEST_LEN] = P2.PAIR_TAG
        self._round_rows(init_rc=tag)
        return self._digest_rows()

    def squeeze(self, pool8: list[int], counter: int) -> list[int]:
        """Transcript squeeze block -> 16 sample cells (base)."""
        rc = [0] * CELLS
        rc[8] = counter
        self._absorb(list(pool8), fresh=True, rc=rc)
        self._round_rows()
        return self._digest_rows(hi=True)

    # -- finalize ---------------------------------------------------------

    def build(self) -> Program:
        n = len(self.typ)
        mult = np.zeros((n, N_SLOTS), dtype=np.uint32)
        for row in range(n):
            for slot in range(N_SLOTS):
                m = self.mult_slot[row][slot]
                if m == 1:
                    mult[row, slot] = 1
                elif m == -1:
                    k = self._reads[self.addr[row][slot]]
                    mult[row, slot] = (P - k) % P
        return Program(
            typ=np.array(self.typ, dtype=np.uint16),
            addr=np.array(self.addr, dtype=np.int64),
            mult=mult,
            rc=np.array(self.rc, dtype=np.uint32),
            s=np.array(self.s, dtype=np.uint32),
            pub=np.array(self.pub, dtype=np.int16),
            wf=np.array(self.wf, dtype=np.int64),
            n_cells=self.n_cells,
            n_stream=self.n_stream,
        )


class RTranscript:
    """In-circuit mirror of zkp.transcript.Transcript."""

    def __init__(self, b: Builder, domain_tag: str = "zeth-tpu:proof:v1"):
        from ..zkp.transcript import Transcript
        self.b = b
        pool0 = Transcript(domain_tag).pool      # known constants
        self.pool = [b.const(int(v)) for v in pool0]
        self._counter = 0
        self._buf: list[int] = []

    def mix_digest(self, digest8: list[int]) -> None:
        self.pool = self.b.pair_hash(self.pool, digest8)
        self._counter = 0
        self._buf = []

    def mix_values(self, cells: list[int]) -> None:
        b = self.b
        flat = list(cells)
        while len(flat) > 64:
            k = (len(flat) + 63) // 64
            flat = flat + [b.ZERO] * (k * 64 - len(flat))
            digests = []
            for i in range(k):
                digests += b.sponge_hash(flat[64 * i:64 * i + 64])
            flat = digests
        self.mix_digest(b.sponge_hash(flat))

    def sample(self) -> int:
        if not self._buf:
            self._buf = self.b.squeeze(self.pool, self._counter)
            self._counter += 1
        return self._buf.pop(0)

    def sample_vec(self, k: int) -> list[int]:
        return [self.sample() for _ in range(k)]

    def sample_ext(self) -> int:
        """One ext cell (combined from 4 base samples)."""
        return self.b.combine_ext(self.sample_vec(4))

    def sample_ext_comps(self) -> tuple[list[int], int]:
        comps = self.sample_vec(4)
        return comps, self.b.combine_ext(comps)

    def sample_index_bits(self, n: int) -> list[int]:
        """Bits of (sample() mod n) for power-of-two n: the low log2(n)
        bits of the canonical 31-bit decomposition."""
        v = self.sample()
        bits = self.b.decompose(v, 31, assert_canonical=True)
        return bits[:n.bit_length() - 1]

    def check_grind(self, bits: int, nonce_cell: int) -> None:
        self.mix_values([nonce_cell])
        v = self.sample()
        vb = self.b.decompose(v, 31, assert_canonical=True)
        low = self.b.dot_const([1 << k for k in range(bits)], vb[:bits])
        self.b.assert_zero(low)
