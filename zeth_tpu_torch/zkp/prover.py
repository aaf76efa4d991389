"""DEEP-ALI STARK prover: the heavy math on a torch device, transcript on host.

Counterpart of the single-device path of ``zeth_tpu.zkp.prover.prove``
(PROTOCOL.md). Stage structure:

  commit control/main/aux groups  (coset LDE + batched Poseidon2 Merkle)
  -> constraint quotient Q = mix(C_i)/Z on the LDE domain (level tape)
  -> "check" group = Q split into 4 coefficient slices x 4 ext components
  -> DEEP taps at z / z*w_n (barycentric, from the stride-4 LDE rows)
  -> DEEP combination polynomial -> FRI (zeth_tpu_torch.zkp.fri)
  -> Merkle openings of every group at the FRI query indices.

Every group's LDE stays resident as an int32 tensor, except a main group
whose LDE exceeds ``STREAM_MAIN_BYTES``: that one is coset-streamed (its
shifted coefficients stay resident and each coset's evaluations are
recomputed where a stage needs them, as the reference streams it).
int64 temporaries are bounded by working on column or row chunks, all
sized from ``field.CHUNK_ELEMS`` (the Merkle pair levels too). An AIR
with a ``build_aux_device`` gets its aux group built on the device from
the standard-form main and control tensors, which stay until that
stage. An AIR with a ``main_bit_mask`` ships its main trace bit-packed
(``_upload_main``: the C packer on the host, the unpack on the device).
Every group takes the radix-2 ``_lde``: the reference's four-step LDE
(``mxu.coset_lde_fs``) gives the same words and is slower on the card
at every shape the reference hands it. The streamed main group's query
rows are one exact field product (``_eval_rows_at_points``). With a
``mesh`` (``prove``'s docstring) the row-indexed stages run sharded over
``torch.distributed`` ranks. Seals equal the reference's word for word.
"""

from __future__ import annotations

import functools
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import field as F
from .. import hostmath as H
from .. import mxu, ntt, staging
from ..convert import resolve_device
from ..hash import merkle
from ..hostmath import GENERATOR, P, RINV
from ..parallel import comm
from ..parallel.dist_ntt import dist_coset_lde
from . import fri, tape
from .air import Air
from .transcript import Transcript

BLOWUP = fri.BLOWUP

# Tap stream order (PROTOCOL.md step 5): offset 0 = z, offset 1 = z*w_n.
TAP_STREAMS = [("control", 0), ("main", 0), ("aux", 0), ("check", 0),
               ("control", 1), ("main", 1), ("aux", 1)]



@dataclass
class GroupOpening:
    rows: np.ndarray     # (n_queries, cols) standard form LDE rows
    paths: list          # n_queries sibling paths (depth, 8)


@dataclass
class StarkProof:
    air_name: str
    po2: int
    publics: list
    roots: dict          # group -> (8,) digest
    taps: np.ndarray     # (n_taps, 4) standard form, TAP_STREAMS order
    fri_proof: fri.FriProof
    openings: dict       # group -> GroupOpening
    query_indices: list


# -- stage timing ---------------------------------------------------------------

TIMING = os.environ.get("ZETH_TIMING", "0") == "1"
STAGE_LOG: list = []          # (stage name, seconds) while TIMING is on
# (stage name, the device's peak allocation so far in bytes) at the end of
# each stage on a CUDA device while TIMING is on: the first stage whose
# value reaches a run's peak is the one that set it
STAGE_PEAKS: list = []


class _Stage:
    """Context timer. With TIMING on it synchronizes the device at the
    stage's end and records (name, seconds) in STAGE_LOG, and on a CUDA
    device (name, peak bytes so far) in STAGE_PEAKS."""

    def __init__(self, name, device=None):
        self.name = name
        self.device = device

    def __enter__(self):
        self.t0 = time.time()

    def __exit__(self, *a):
        if not TIMING:
            return
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
            STAGE_PEAKS.append(
                (self.name, torch.cuda.max_memory_allocated(self.device)))
        dt = time.time() - self.t0
        STAGE_LOG.append((self.name, dt))
        print(f"[prover] {self.name}: {dt:.2f}s", file=sys.stderr, flush=True)


# -- host helpers -----------------------------------------------------------------


def _to_dev(a_std, device) -> torch.Tensor:
    """Standard-form host values -> Montgomery int32 tensor."""
    return torch.from_numpy(H.to_monty_np(a_std).view(np.int32)).to(device)


def _upload_std(a_std: np.ndarray, device) -> torch.Tensor:
    """(n, c) standard-form host matrix -> standard-form int32 tensor."""
    a32 = np.ascontiguousarray(np.asarray(a_std, np.uint64).astype(np.uint32))
    return torch.from_numpy(a32.view(np.int32)).to(device)


def _host_std(t: torch.Tensor) -> np.ndarray:
    """Montgomery int32 tensor -> standard-form numpy uint64."""
    return H.from_monty_np(t.cpu().numpy().view(np.uint32))


def _zinv_std(n: int) -> list:
    """Standard-form (BLOWUP,) table of 1/(x^n - 1) on the LDE coset
    (4-periodic); the reference's ``_zinv_table`` in standard form, so the
    division is one ``mul_std``."""
    gn = pow(GENERATOR, n, P)
    w4 = H.rou_fwd(BLOWUP)
    vals = [(gn * pow(w4, i, P) - 1) % P for i in range(BLOWUP)]
    return [pow(v, P - 2, P) for v in vals]


def scalar_publics(air: Air, publics):
    """The leading publics that enter constraints as scalars."""
    n_ps = getattr(air, "n_public_scalars", None)
    return publics if n_ps is None else publics[:n_ps]


def all_challenges(air: Air, publics, sampled: np.ndarray,
                   derived_extra=None) -> np.ndarray:
    """Sampled challenges + the AIR's derived challenge-like scalars.

    derived_extra may be a callable taking the sampled challenges (the
    prover computes companion-bound values like d0/d1 only once the
    shared challenges exist) or a plain dict (the verifier passes the
    companion proof's public values)."""
    if not getattr(air, "n_derived", 0):
        return sampled
    if callable(derived_extra):
        derived_extra = derived_extra(sampled)
    derived = np.asarray(
        air.derived_challenges(publics, sampled, extra=derived_extra),
        np.uint64).reshape(-1, 4)
    return np.concatenate([sampled.reshape(-1, 4), derived], axis=0)


# Air registry + cached constraint tapes: ``air.constraints()`` is captured
# once per (air, publics count) into a linear tape (zkp/tape.py).
_AIRS: dict[str, Air] = {}
_TAPES: dict = {}


def register_air(air: Air) -> None:
    _AIRS[air.name] = air


def _tape_program(air_name: str, n_publics: int):
    key = (air_name, n_publics)
    tp = _TAPES.get(key)
    if tp is None:
        air = _AIRS[air_name]
        n_chal = air.n_challenges + getattr(air, "n_derived", 0)
        tp = tape.capture(
            air, n_publics,
            lambda cap: [tuple(cap.scalar(("chal", i, c)) for c in range(4))
                         for i in range(n_chal)])
        _TAPES[key] = tp
    return tp


# -- LDE --------------------------------------------------------------------------


def _lde_group(trace_monty):
    """(n, c) trace -> (coeffs (n, c), lde (4n, c)) on the coset 31*<w_4n>."""
    n, c = trace_monty.shape
    coeffs = ntt.intt(trace_monty)
    scaled = F.mul_std(coeffs, ntt.power_table(GENERATOR, n,
                                               trace_monty.device)[:, None])
    padded = torch.zeros((BLOWUP * n, c), dtype=torch.int32,
                         device=trace_monty.device)
    padded[:n] = scaled
    return coeffs, ntt.ntt(padded)


def _by_columns(fn, x, rows_out: int):
    """fn over column chunks of x, each result (rows_out, w) int32 holding
    about F.CHUNK_ELEMS elements, written into one (rows_out, c) tensor."""
    c = x.shape[1]
    out = torch.empty((rows_out, c), dtype=torch.int32, device=x.device)
    w = max(1, F.CHUNK_ELEMS // rows_out)
    for off in range(0, c, w):
        out[:, off:off + w] = fn(x[:, off:off + w])
    return out


def _lde(dev, std: bool, mesh=None):
    """Column-chunked LDE of an (n, c) tensor (standard form if `std`,
    else Montgomery) into a resident (4n, c) Montgomery tensor. With a
    mesh, `dev` is this rank's row block of the trace and the result its
    row block of the LDE (``parallel.dist_coset_lde``)."""
    def lde(ch):
        ch = F.to_monty(ch) if std else ch.contiguous()
        if mesh is None:
            return _lde_group(ch)[1]
        return dist_coset_lde(ch, mesh)
    return _by_columns(lde, dev, BLOWUP * dev.shape[0])


def _commit(lde, mesh=None):
    """The Merkle tree of an LDE: one rank's subtree and the replicated
    top levels with a mesh."""
    if mesh is None:
        return merkle.commit_rows(lde)
    return merkle.commit_rows_sharded(lde, mesh)


def _gather_rows(x, mesh):
    """This rank's row block of a sharded tensor -> the whole tensor on
    every rank."""
    return comm.all_gather(x, mesh).reshape((-1,) + tuple(x.shape[1:]))


# -- bit-packed main upload -------------------------------------------------------
#
# Most main columns of the rv32im, paging and accelerator AIRs are bits
# (971 of the rv32im's 1,009). The host packs the bit columns into 32-bit
# words and the value columns into a narrow matrix (the C packer,
# executor/csrc/pack.cpp, threaded over row ranges), and the device
# unpacks them into the standard-form matrix that ``_upload_std`` gives.


@functools.lru_cache(maxsize=None)
def _pack_spec(air_name: str):
    """(spec, mask, n_bits, n_vals) of a registered AIR's main_bit_mask:
    spec = (word_idx, bit_off, col_src, val_idx) per main column (col_src
    0 = bit, 1 = value), as tuples."""
    air = _AIRS[air_name]
    mask = np.asarray(air.main_bit_mask, bool)
    n_cols = mask.shape[0]
    word_idx = np.zeros(n_cols, dtype=np.int32)
    bit_off = np.zeros(n_cols, dtype=np.int32)
    col_src = np.ones(n_cols, dtype=np.int32)    # 0 = bit, 1 = value
    val_idx = np.zeros(n_cols, dtype=np.int32)
    b = v = 0
    for c in range(n_cols):
        if mask[c]:
            word_idx[c] = b // 32
            bit_off[c] = b % 32
            col_src[c] = 0
            b += 1
        else:
            val_idx[c] = v
            v += 1
    return (tuple(word_idx.tolist()), tuple(bit_off.tolist()),
            tuple(col_src.tolist()), tuple(val_idx.tolist())), mask, b, v


def _unpack_main(packed, vals, spec):
    """(n, words) packed bits + (n, n_vals) values, int32 -> (n,
    main_cols) standard-form int32: column c is bit bit_off[c] of word
    word_idx[c] where col_src[c] is 0, else value column val_idx[c]. Row
    chunks bound the gathers to about ``field.CHUNK_ELEMS`` elements."""
    word_idx, bit_off, is_bit, val_idx = ntt._device_table(
        ("unpack", spec), packed.device, lambda: (
            torch.tensor(spec[0], dtype=torch.int64),
            torch.tensor(spec[1], dtype=torch.int32),
            torch.tensor([s == 0 for s in spec[2]]),
            torch.tensor(spec[3], dtype=torch.int64)))
    n, c = packed.shape[0], word_idx.shape[0]
    out = torch.empty((n, c), dtype=torch.int32, device=packed.device)
    rows = max(1, F.CHUNK_ELEMS // max(c, 1))
    for r0 in range(0, n, rows):
        # words are uint32 bit patterns in int32: >> sign-extends bit 31,
        # so the bit is masked after the shift
        bits = (packed[r0:r0 + rows].index_select(1, word_idx) >> bit_off) & 1
        torch.where(is_bit, bits,
                    vals[r0:r0 + rows].index_select(1, val_idx),
                    out=out[r0:r0 + rows])
        del bits
    return out


# Reusable host staging buffers, keyed by shape: a fresh multi-GB host
# allocation faults in page by page, reuse keeps the pages resident. For
# a CUDA device they are pinned, so the copies run asynchronously; the
# event of a buffer's last copy is awaited before it is written again.
_STAGE_BUFS: dict = {}


def _staged(key: str, shape: tuple, device) -> list:
    """[int32 host tensor of `shape`, event of its last copy or None]."""
    pin = device.type == "cuda"
    k = (key, tuple(shape), pin)
    ent = _STAGE_BUFS.get(k)
    if ent is None:
        ent = _STAGE_BUFS[k] = [torch.empty(shape, dtype=torch.int32,
                                            pin_memory=pin), None]
    elif ent[1] is not None:
        ent[1].synchronize()
    return ent


def _upload_main(air: Air, main_std: np.ndarray, device) -> torch.Tensor:
    """The (n, main_cols) standard-form main trace on `device`, equal to
    ``_upload_std(main_std, device)``. An AIR with a ``main_bit_mask``
    ships it bit-packed (packed on the host by ``executor.pack_rows``,
    unpacked on the device); any other is shipped raw."""
    if getattr(air, "main_bit_mask", None) is None:
        return _upload_std(main_std, device)
    from ..executor import pack_rows
    register_air(air)
    spec, mask, n_bits, n_vals = _pack_spec(air.name)
    n = main_std.shape[0]
    bit_idx = np.nonzero(mask)[0]
    val_idx = np.nonzero(~mask)[0]
    bufs = (_staged("packed", (n, (n_bits + 31) // 32), device),
            _staged("vals32", (n, max(n_vals, 1)), device))
    with _Stage("    pack host", device):
        packed, vals = (b[0].numpy().view(np.uint32) for b in bufs)
        m64 = np.ascontiguousarray(main_std, np.uint64)
        n_chunks = min(staging._N_THREADS, max(1, n // 8192))
        step = -(-n // n_chunks)
        futs = [staging._pool().submit(pack_rows, m64, bit_idx, val_idx,
                                       packed, vals, r0, min(r0 + step, n))
                for r0 in range(0, n, step)]
        for f in futs:
            f.result()
    with _Stage("    put packed", device):
        dm = bufs[0][0].to(device, non_blocking=True)
    with _Stage("    put vals", device):
        dv = bufs[1][0].to(device, non_blocking=True)
    if device.type == "cuda":
        for b in bufs:
            b[1] = torch.cuda.Event()
            b[1].record(torch.cuda.current_stream(device))
    with _Stage("    unpack", device):
        return _unpack_main(dm, dv, spec)


def commit_main(air: Air, main_std: np.ndarray, device=None):
    """Commit the main group exactly as prove() does, on `device` (None:
    the CUDA card); returns (root (8,) np.uint64, handle) where handle =
    (standard-form device trace, LDE, tree) can be passed back to
    prove(main_commit=handle) to reuse them (used to pre-commit a
    companion proof's trace into another transcript via
    prove(extra_mix=...) before the shared challenges are sampled)."""
    dev = _upload_main(air, main_std, resolve_device(device))
    lde = _lde(dev, std=True)
    tree = merkle.commit_rows(lde)
    return tree.root, (dev, lde, tree)


# -- streamed main group ------------------------------------------------------
#
# Above STREAM_MAIN_BYTES the main group's blowup-4 LDE is never formed:
# the g-shifted coefficients (n, c) stay resident (a quarter of the LDE)
# and one coset's evaluations are recomputed where a stage needs them.
# The LDE domain g*<w_4n> is the union of the 4 cosets g*w_4n^r*<w_n>,
# and LDE row 4k+r is coset r at position k. The Merkle leaves hash coset
# by coset and interleave; the check polynomial evaluates coset by coset
# (tape stride 1, the control and aux groups as strided views); the taps
# and the DEEP mix read only coset 0 (the stride-4 rows); each queried
# row is read from its recomputed coset. Seals equal the resident path's.

# The po2=24 recursion main LDE (2^26 x 84 int32, 21.0 GiB) streams: with
# it resident the groups and trees of that proof hold ~71.5 GiB of the
# card's 80 GB before any transient. The po2=20 rv32im main LDE (2^22 x
# 1,009, 15.8 GiB) stays resident, as EVM segments have always proved
# (peak ~26 GiB); so do every smaller group and a pre-committed main.
STREAM_MAIN_BYTES = 18 << 30


def _shifted_coeffs(dev_std):
    """(n, c) standard-form trace -> (n, c) Montgomery coefficients of
    f(g*x), column-chunked."""
    n = dev_std.shape[0]
    sp = ntt.power_table(GENERATOR, n, dev_std.device)[:, None]
    return _by_columns(lambda ch: F.mul_std(ntt.intt(F.to_monty(ch)), sp),
                       dev_std, n)


def _coset_eval(coeffs1, r: int, n: int):
    """Coset r's evaluations of the columns whose shifted coefficients are
    `coeffs1`: (n, c) Montgomery, equal to LDE rows 4k+r."""
    wr = pow(H.rou_fwd(BLOWUP * n), r, P)
    rp = ntt.power_table(wr, n, coeffs1.device)[:, None]
    return _by_columns(lambda ch: ntt.ntt(F.mul_std(ch, rp)), coeffs1, n)


def _interleave4(parts):
    """4 x (n, k) per-coset arrays -> (4n, k) in natural LDE order."""
    n, k = parts[0].shape
    return torch.stack(tuple(parts), dim=1).reshape(BLOWUP * n, k)


def _coset_rows(lde, r: int):
    """Rows 4k+r of a resident (4n, c) LDE: coset r, as a strided view."""
    return lde[r::BLOWUP]


def _eval_rows_at_points(coeffs1, pts_m, n: int):
    """Rows of the columns whose shifted coefficients are `coeffs1`
    ((n, c) Montgomery) at the points pts_m ((Q,) Montgomery, the LDE
    points w_4n^q), straight from the coefficients: row q = sum_j
    coeffs1[j, :] * x_q^j, an exact field product (``mxu.modmm``) of the
    points' standard-form power rows against the coefficients. Returns
    (Q, c) Montgomery. The power rows are made on the device in blocks of
    whole ``mxu._MAX_K`` chunks, so the sums chunk as one modmm call over
    all n would, with a bounded (Q, block) operand."""
    dev = coeffs1.device
    x = F.from_monty(pts_m).to(torch.int64)[:, None]          # (Q, 1)
    blk = min(n, 16 * mxu._MAX_K)
    pw = torch.ones((x.shape[0], 1), dtype=torch.int64, device=dev)
    while pw.shape[1] < blk:                  # x^0 .. x^(blk-1), doubling
        pw = torch.cat([pw, pw * (pw[:, -1:] * x % P) % P], dim=1)
    x_blk = pw[:, -1:] * x % P                                # x^blk
    scale = torch.ones_like(x)
    out = None
    for off in range(0, n, blk):
        r = mxu.modmm((pw * scale % P).to(torch.int32),
                      coeffs1[off:off + blk])
        out = r if out is None else F.add(out, r)
        scale = scale * x_blk % P
    return out


# -- check group -------------------------------------------------------------------


def _finish_check(acc, n: int):
    """acc (4n, 4) alpha-mix -> (n, 16) check columns (evaluations on H)."""
    dev = acc.device
    m = BLOWUP * n
    # 1/(x^n - 1) is 4-periodic on the LDE coset
    zinv = torch.tensor(_zinv_std(n), dtype=torch.int64,
                        device=dev)[None, :, None]
    q_evals = F.mul_std(acc.reshape(n, BLOWUP, 4), zinv).reshape(m, 4)
    qc = ntt.intt(q_evals)                                     # coset iNTT
    sinv = ntt.power_table(pow(GENERATOR, P - 2, P), m, dev)
    qc = F.mul_std(qc, sinv[:, None])
    # split: 4 slices (k) x 4 ext components -> (n, 16), col = 4k + comp
    cols = qc.reshape(BLOWUP, n, 4).transpose(0, 1).reshape(n, 16)
    # Commit the check group as evaluations on H so the interpolating
    # polynomial of each column is exactly Q_{k,comp} (tap consistency).
    return ntt.ntt(cols.contiguous())


def _check_tape(air: Air, alpha: np.ndarray, publics):
    """The AIR's constraint tape, its scalar publics and alpha's powers."""
    register_air(air)
    pubs_s = scalar_publics(air, publics)
    tp = _tape_program(air.name, len(pubs_s))
    # committed columns have degree <= n-1, so a total constraint degree
    # D gives deg(Q) <= D(n-1) - n <= 4n-1 exactly when D <= BLOWUP+1
    assert tp.max_degree <= BLOWUP + 1, \
        f"constraint degree {tp.max_degree} exceeds blowup+1 = {BLOWUP + 1}"
    return tp, pubs_s, H.ext_powers(alpha, tp.n_stage)


def _halo(tp, ldes: dict, mesh) -> dict:
    """Per group, the first ``STRIDE * max_offset`` rows of the next
    rank's LDE block (rank 0's for the last rank): the rows the tape's
    next-trace-row leaves read past the end of this rank's block."""
    h = tape.STRIDE * tape.max_offset(tp)
    nxt = (comm.rank(mesh) + 1) % comm.size(mesh)
    return {g: comm.all_gather(lde[:h], mesh)[nxt]
            for g, lde in ldes.items() if lde.shape[1]}


def _check_group(air: Air, ldes: dict, alpha: np.ndarray, publics,
                 challenges, n: int, mesh=None):
    """Build the check group: Q = mix(C_i)/Z split into 16 base columns.
    With a mesh each rank evaluates the tape on its LDE row block,
    extended by the halo of the next rank's first rows (cyclic); the
    (4n, 4) mix is gathered and finished on every rank."""
    tp, pubs_s, alpha_pows = _check_tape(air, alpha, publics)
    dev = next(iter(ldes.values())).device
    halo = None if mesh is None else _halo(tp, ldes, mesh)
    with _Stage(f"  constraint tape ({tp.ops.shape[0]} ops, "
                f"{tp.n_stage} constraints)", dev):
        acc = tape.eval_check(tp, ldes, pubs_s, challenges, alpha_pows,
                              halo=halo)
    if mesh is not None:
        acc = _gather_rows(acc, mesh)
    return _finish_check(acc, n)


def _check_group_streamed(air: Air, coeffs1, ldes: dict, alpha: np.ndarray,
                          publics, challenges, n: int):
    """_check_group with a streamed main group: the tape evaluates coset
    by coset (stride 1) and the four alpha-mixes interleave back into LDE
    order, so Q is the resident path's word for word."""
    tp, pubs_s, alpha_pows = _check_tape(air, alpha, publics)
    parts = []
    with _Stage(f"  constraint tape, 4 cosets ({tp.ops.shape[0]} ops, "
                f"{tp.n_stage} constraints)", coeffs1.device):
        for r in range(BLOWUP):
            sub = {"main": _coset_eval(coeffs1, r, n)}
            for g in ("control", "aux"):
                if ldes[g].shape[1]:
                    sub[g] = _coset_rows(ldes[g], r)
            parts.append(tape.eval_check(tp, sub, pubs_s, challenges,
                                         alpha_pows, stride=1))
            del sub
        acc = _interleave4(parts)
    del parts
    return _finish_check(acc, n)


# -- DEEP taps and combination --------------------------------------------------


def _rows_dot(rows, w, stride: int = BLOWUP, mesh=None):
    """sum_k rows[stride*k, c] * w[k, e] (Montgomery) -> (c, e).

    rows: (stride*n, c) Montgomery -- a (4n, c) LDE read at its stride-4
    rows, or (stride 1) one coset's (n, c) evaluations; w: (n, e)
    Montgomery. Products are reduced per term and summed in int64 (exact:
    the order of the additions does not matter), then scaled by R^-1
    once. With a mesh `rows` and `w` are this rank's row blocks: the D
    reduced partial sums add exactly in int64 (all_reduce) before the
    last reduction."""
    c = rows.shape[1]
    n, e = w.shape
    chunk = max(1, min(n, F.CHUNK_ELEMS // 4 // max(c * e, 1)))
    acc = torch.zeros((c, e), dtype=torch.int64, device=rows.device)
    for k0 in range(0, n, chunk):
        k1 = min(n, k0 + chunk)
        r = rows[stride * k0:stride * k1:stride].to(torch.int64)
        t = r[:, :, None] * w[k0:k1].to(torch.int64)[:, None, :]
        acc += torch.fmod(t, P).sum(dim=0)
        del r, t
    acc = torch.fmod(acc, P)
    if mesh is not None:
        acc = torch.fmod(comm.all_reduce_sum(acc, mesh), P)
    return torch.fmod(acc * RINV, P).to(torch.int32)


def _point_inverses(x_pows, z_monty):
    """ext inverse of (x_i - z) for all LDE points. x_pows: (4n,) base.
    Row-chunked: a few dozen (rows,) int64 temporaries per chunk."""
    m = x_pows.shape[0]
    rows = F.CHUNK_ELEMS // 64
    out = torch.empty((m, 4), dtype=torch.int32, device=x_pows.device)
    for i in range(0, m, rows):
        x = x_pows[i:i + rows]
        diff0 = F.sub(x, z_monty[0])
        rest = F.neg(z_monty[1:]).expand(x.shape[0], 3)
        out[i:i + x.shape[0]] = F.ext_inv(
            torch.cat([diff0[:, None], rest], dim=1))
    return out


def _taps_fused(groups, z_m, zg_m, n: int, strides, mesh=None):
    """Every DEEP tap plus the (x - z)^-1 tables.

    groups: Montgomery row arrays, each read at its stride in `strides`
    ((4n, c) LDEs at stride 4; the streamed main group's coset-0
    evaluations (n, c) at stride 1). Returns (per-group (c, 8) Montgomery
    tap values ([:, :4] at z, [:, 4:] at z*w_n), inv_z, inv_zg); the
    inverse tables are reused by the DEEP combination. On the coset gH of
    size 4n: f(z) = K(z) * sum_i f(x_i) * x_i / (z - x_i) with
    K(z) = (z^4n - g^4n) / (4n * g^4n); every committed column has degree
    < n, so its tap interpolates exactly from the n stride-4 rows. With a
    mesh the groups are this rank's LDE row blocks, the point and inverse
    tables its slice of the domain, and the taps sum over the ranks.
    """
    dev = z_m.device
    m4 = BLOWUP * n
    lo, rows = 0, m4
    if mesh is not None:
        rows = m4 // comm.size(mesh)
        lo = comm.rank(mesh) * rows
    x_std = ntt.power_table(H.rou_fwd(m4), m4, dev)[lo:lo + rows]
    x_pows = F.to_monty(torch.fmod(x_std * GENERATOR, P))
    inv_z = _point_inverses(x_pows, z_m)
    inv_zg = _point_inverses(x_pows, zg_m)
    x4 = x_pows[::4]
    gn = pow(GENERATOR, n, P)
    den_inv = pow((n * gn) % P, P - 2, P)
    gn_m = _to_dev(np.array([gn, 0, 0, 0], np.uint64), dev)

    def bary(zz_m, inv4):
        zn = F.ext_pow_const(zz_m, n)
        mk = F.neg(F.mul_std(F.ext_sub(zn, gn_m), den_inv))
        return F.ext_mul(F.ext_mul_base(inv4, x4),
                         mk.expand(x4.shape[0], 4))

    bw_pair = torch.cat([bary(z_m, inv_z[::4]), bary(zg_m, inv_zg[::4])],
                        dim=1)
    outs = tuple(_rows_dot(g, bw_pair, st, mesh)
                 for g, st in zip(groups, strides))
    return outs, inv_z, inv_zg


def _deep_mix_s4(groups, bps_z, n_zg_groups: int, strides):
    """Beta-mixes of all committed columns on the stride-4 subdomain.

    mix_z(x) = sum_c beta^c f_c(x) is itself a degree-<n polynomial, so
    the n stride-4 LDE rows determine it. Each group is read at its
    stride (1: the streamed main group's coset-0 evaluations). Returns
    (n, 8): [:, :4] = mix over all groups, [:, 4:] = mix over the first
    n_zg_groups."""
    n = groups[0].shape[0] // strides[0]
    dev = groups[0].device
    acc_z = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    acc_pre = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    for gi, (cat, bz, st) in enumerate(zip(groups, bps_z, strides)):
        c = cat.shape[1]
        b64 = bz.to(torch.int64)
        chunk = max(1, min(n, F.CHUNK_ELEMS // 4 // max(c * 4, 1)))
        s = torch.empty((n, 4), dtype=torch.int64, device=dev)
        for k0 in range(0, n, chunk):
            k1 = min(n, k0 + chunk)
            r = cat[st * k0:st * k1:st].to(torch.int64)
            s[k0:k1] = torch.fmod(r[:, :, None] * b64[None], P).sum(dim=1)
            del r
        s = torch.fmod(torch.fmod(s, P) * RINV, P)
        acc_z += s
        if gi < n_zg_groups:
            acc_pre += s
    return torch.fmod(torch.cat([acc_z, acc_pre], dim=1), P).to(torch.int32)


def _extend_coset_evals(vals):
    """(n, c) evaluations on g*<w_n> -> (4n, c) on g*<w_4n>. The coset
    shift cancels: with q(y) = f(g*y), the values are q on <w_n> and the
    target is q on <w_4n> -- a plain (unshifted) blowup-4 LDE."""
    n = vals.shape[0]

    def extend(ch):
        padded = torch.zeros((BLOWUP * n, ch.shape[1]), dtype=torch.int32,
                             device=ch.device)
        padded[:n] = ntt.intt(ch)
        return ntt.ntt(padded)

    return _by_columns(extend, vals, BLOWUP * n)


def _deep_f0(mix4, beta_nz, cz, cpre, iz, izg):
    """f0(x) = [mix_z(x) - c_z]/(x - z)
             + beta^n_z * [mix_pre(x) - c_pre]/(x - zg), row-chunked
    as _point_inverses."""
    n4 = mix4.shape[0]
    rows = F.CHUNK_ELEMS // 64
    out = torch.empty((n4, 4), dtype=torch.int32, device=mix4.device)
    for i in range(0, n4, rows):
        j = min(n4, i + rows)
        num_z = F.ext_sub(mix4[i:j, :4], cz.expand(j - i, 4))
        num_pre = F.ext_sub(mix4[i:j, 4:], cpre.expand(j - i, 4))
        num_zg = F.ext_mul(num_pre, beta_nz.expand(j - i, 4))
        out[i:j] = F.add(F.ext_mul(num_z, iz[i:j]),
                         F.ext_mul(num_zg, izg[i:j]))
    return out


def _lde_query_rows(lde, qs, mesh=None):
    """Standard-form rows of a resident LDE at the query indices. With a
    mesh `lde` is this rank's row block: each rank reads the rows at the
    queries' local indices, the fixed-size (Q, c) results are gathered,
    and each query takes the rank that owns it."""
    q = np.asarray(qs, np.int64)
    m = lde.shape[0]
    idx = torch.as_tensor(q % m, device=lde.device)
    rows = lde.index_select(0, idx)
    if mesh is not None:
        owner = torch.as_tensor(q // m, device=lde.device)
        rows = comm.all_gather(rows, mesh)[
            owner, torch.arange(q.shape[0], device=lde.device)]
    return _host_std(rows)


# -- prove ----------------------------------------------------------------------------


def prove(air: Air, main_std: np.ndarray, publics: list[int],
          derived_extra=None, extra_mix=None, main_commit=None,
          device=None, mesh=None) -> StarkProof:
    """Prove one AIR execution on `device` (None: the CUDA card; without
    one the call raises). main_std: (n, main_cols) standard-form trace.
    The seal (``proof.encode``) equals the reference prover's for the
    same inputs.

    mesh: a 1-D ``DeviceMesh`` with a ``rows`` dimension over D ranks
    (``parallel.pod_mesh``), every rank calling prove with the same
    arguments. Each rank then holds the contiguous row block d of every
    trace and LDE on its card (``cuda:(local_rank % cards)``, or the CPU
    with ``device="cpu"``): the uploads, LDEs (``dist_coset_lde``),
    Merkle commits (``merkle.commit_rows_sharded``), the constraint tape
    (with a halo of the next rank's rows), the DEEP taps and the DEEP
    combination run sharded. The check group's (4n, 4) mix and the DEEP
    polynomial (4n, 4) are gathered, and ``_finish_check`` and FRI run
    replicated (the ranks share FRI's grind); the query openings are
    gathered from their owners.
    Every rank runs the same transcript and returns the same proof, whose
    seal equals the unsharded one. The main group is never streamed and
    the aux group is built by the host ``build_aux``, as in the
    reference's mesh path."""
    device = resolve_device(device, mesh)
    n, c_main = main_std.shape
    assert c_main == air.main_cols and n & (n - 1) == 0
    po2 = n.bit_length() - 1
    if mesh is not None and main_commit is not None:
        raise ValueError("prove: a pre-committed main group is not sharded")
    lo, hi = 0, n                  # this rank's trace rows
    if mesh is not None:
        lo = comm.rank(mesh) * n // comm.size(mesh)
        hi = lo + n // comm.size(mesh)

    t = Transcript()
    t.mix_values(np.array([po2] + [int(p) for p in publics], dtype=np.uint64))

    # --- commit control / main ------------------------------------------
    # keep the standard-form device tensors when the AIR can build its aux
    # group on the device (no host aux matrix, no second big upload)
    device_aux = mesh is None and hasattr(air, "build_aux_device")
    # a main LDE too big to keep is coset-streamed (module comment above
    # STREAM_MAIN_BYTES); a pre-committed or sharded main group stays
    # resident
    stream_main = (mesh is None and main_commit is None
                   and BLOWUP * n * air.main_cols * 4 > STREAM_MAIN_BYTES)
    main_coeffs = None
    ldes, trees, roots = {}, {}, {}
    dev_std = {}
    for gname in ("control", "main"):
        if gname == "main" and main_commit is not None:
            dev, ldes["main"], trees["main"] = main_commit
            if device_aux:
                dev_std["main"] = dev
            del dev
            roots["main"] = trees["main"].root
            t.mix(roots["main"])
            continue
        with _Stage(f"commit {gname}", device):
            if gname == "control":
                with _Stage("  control trace (host)", device):
                    src = air.control_trace(po2)
            else:
                src = main_std
            with _Stage(f"  {gname} upload", device):
                dev = _upload_std(src[lo:hi], device) if gname == "control" \
                    else _upload_main(air, src[lo:hi], device)
            if gname == "main" and stream_main:
                with _Stage("  main coefficients", device):
                    main_coeffs = _shifted_coeffs(dev)
            else:
                with _Stage(f"  {gname} lde", device):
                    ldes[gname] = _lde(dev, std=True, mesh=mesh)
            if device_aux:
                dev_std[gname] = dev
            del dev
            with _Stage(f"  {gname} tree", device):
                if gname == "main" and stream_main:
                    trees["main"] = merkle.commit_digests(_interleave4(
                        [merkle.leaf_digests(_coset_eval(main_coeffs, r, n))
                         for r in range(BLOWUP)]))
                else:
                    trees[gname] = _commit(ldes[gname], mesh)
            roots[gname] = trees[gname].root
        t.mix(roots[gname])

    # companion-proof commitment (e.g. the paging proof's main root):
    # mixed before challenge sampling so witness bound by the companion
    # is committed before the shared challenges exist (LogUp ordering)
    if extra_mix is not None:
        t.mix(np.asarray(extra_mix, np.uint64).reshape(8))

    # --- aux group -------------------------------------------------------
    sampled = np.stack([t.sample_ext() for _ in range(air.n_challenges)]) \
        if air.n_challenges else np.zeros((0, 4), dtype=np.uint64)
    # host work: the AIR's derived scalars (for rv32im the RLCs over the
    # segment's public IO lists) and, through derived_extra, whatever the
    # companion proof needs under the shared challenges
    with _Stage("derived challenges (host)", device):
        challenges = all_challenges(air, publics, sampled, derived_extra)
    if air.aux_cols:
        with _Stage("commit aux", device):
            if device_aux:
                with _Stage("  aux witgen (device)", device):
                    aux_m = air.build_aux_device(
                        dev_std["main"], dev_std["control"], challenges)
                dev_std.clear()
                ldes["aux"] = _lde(aux_m, std=False)
                del aux_m
            else:
                with _Stage("  aux witgen (host)", device):
                    aux_std = air.build_aux(np.asarray(main_std, np.uint64),
                                            challenges)
                ldes["aux"] = _lde(_upload_std(aux_std[lo:hi], device),
                                   std=True, mesh=mesh)
                del aux_std
            trees["aux"] = _commit(ldes["aux"], mesh)
            roots["aux"] = trees["aux"].root
        t.mix(roots["aux"])
    else:
        ldes["aux"] = torch.zeros((BLOWUP * (hi - lo), 0),
                                  dtype=torch.int32, device=device)

    # --- composition / check group --------------------------------------
    alpha = t.sample_ext()
    with _Stage("check group", device):
        if stream_main:
            check_cols = _check_group_streamed(air, main_coeffs, ldes, alpha,
                                               publics, challenges, n)
        else:
            check_cols = _check_group(air, ldes, alpha, publics, challenges,
                                      n, mesh)
        ldes["check"] = _lde(check_cols[lo:hi], std=False, mesh=mesh)
        del check_cols
        trees["check"] = _commit(ldes["check"], mesh)
        roots["check"] = trees["check"].root
    t.mix(roots["check"])

    # --- DEEP taps -------------------------------------------------------
    z = t.sample_ext()
    w_n = H.rou_fwd(n)
    zg = H.ext_mul(H.ext(z), H.ext(w_n))
    # what the taps and the DEEP mix read of each group: its stride-4 LDE
    # rows, or the streamed main group's coset-0 evaluations at stride 1
    s4 = {g: (ldes[g], BLOWUP) for g in ldes}
    if stream_main:
        with _Stage("  main coset 0", device):
            s4["main"] = (_coset_eval(main_coeffs, 0, n), 1)
    width = {g: rows.shape[1] for g, (rows, _) in s4.items()}
    gnames = [g for g in ("control", "main", "aux", "check") if width[g]]
    with _Stage("taps", device):
        gv_dev, inv_z, inv_zg = _taps_fused(
            tuple(s4[g][0] for g in gnames), _to_dev(z, device),
            _to_dev(zg, device), n, tuple(s4[g][1] for g in gnames), mesh)
        group_vals = {g: _host_std(v) for g, v in zip(gnames, gv_dev)}
    tap_vals = []
    for (gname, offset) in TAP_STREAMS:
        if width[gname] == 0:
            tap_vals.append(np.zeros((0, 4), dtype=np.uint64))
            continue
        tap_vals.append(group_vals[gname][:, 4 * offset:4 * offset + 4])
    taps = np.concatenate(tap_vals, axis=0)
    t.mix_values(taps.reshape(-1))

    # --- DEEP combination ------------------------------------------------
    beta = t.sample_ext()
    n_z = air.control_cols + air.main_cols + air.aux_cols + 16
    n_zg = air.control_cols + air.main_cols + air.aux_cols
    beta_pows = H.ext_powers(beta, n_z + n_zg)            # (ntaps, 4) std
    const_z = np.zeros(4, dtype=np.uint64)
    const_pre = np.zeros(4, dtype=np.uint64)     # const_zg / beta^n_z
    for j in range(n_z):
        const_z = H.ext_add(const_z, H.ext_mul(beta_pows[j], taps[j]))
    for j in range(n_zg):
        const_pre = H.ext_add(const_pre,
                              H.ext_mul(beta_pows[j], taps[n_z + j]))

    # The DEEP combination orders zg-groups first in the beta-power
    # stream (weights beta^(n_z + j) for the control/main/aux prefix);
    # beta^n_z is factored out so both mixes share one set of products.
    bps_z = []
    off = 0
    for g in ("control", "main", "aux", "check"):
        if width[g]:
            bps_z.append(_to_dev(beta_pows[off:off + width[g]], device))
        off += width[g]
    n_zg_groups = sum(1 for g in ("control", "main", "aux") if width[g])
    with _Stage("deep combine", device):
        mix_n = _deep_mix_s4(tuple(s4[g][0] for g in gnames), bps_z,
                             n_zg_groups, tuple(s4[g][1] for g in gnames))
        del s4, bps_z, gv_dev
        # the mix's blowup-4 extension: an unshifted LDE (with a mesh,
        # this rank's rows of it)
        mix4 = _extend_coset_evals(mix_n) if mesh is None \
            else dist_coset_lde(mix_n, mesh, shift=1)
        f0 = _deep_f0(mix4, _to_dev(beta_pows[n_z], device),
                      _to_dev(const_z, device), _to_dev(const_pre, device),
                      inv_z, inv_zg)
        del mix_n, mix4, inv_z, inv_zg
        if mesh is not None:
            f0 = _gather_rows(f0, mesh)

    # --- FRI + query openings -------------------------------------------
    with _Stage("fri", device):
        fri_proof, qs = fri.prove(f0, GENERATOR, n, t, mesh)
    del f0
    openings = {}
    with _Stage("openings", device):
        for g in ("control", "main", "aux", "check"):
            if g not in gnames:
                openings[g] = GroupOpening(
                    rows=np.zeros((len(qs), 0), dtype=np.uint64), paths=[])
                continue
            if g == "main" and stream_main:
                # no LDE of the main group exists: its rows evaluate
                # straight from the coefficients
                w4n = H.rou_fwd(BLOWUP * n)
                pts = np.array([pow(w4n, int(q), P) for q in qs], np.uint64)
                rows = _host_std(_eval_rows_at_points(
                    main_coeffs, _to_dev(pts, device), n))
            else:
                rows = _lde_query_rows(ldes[g], qs, mesh)
            openings[g] = GroupOpening(rows=rows,
                                       paths=trees[g].open_many(qs))

    return StarkProof(air_name=air.name, po2=po2, publics=list(publics),
                      roots=roots, taps=taps, fri_proof=fri_proof,
                      openings=openings, query_indices=qs)
