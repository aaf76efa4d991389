"""zkVM host API: executor env, prover dispatch, receipts.

Counterpart of ``zeth_tpu.zkvm``, a jax-free copy of its segments path:
``LocalProver`` proves every segment (rv32im + paging) and the
accelerator batches on `device` (None: the CUDA card), and
``Receipt.verify`` runs the STARK verifies, the chain checks and the
accelerator resolve, recomputing the control roots on `device`. The
succinct receipt (``SuccinctInner``, ``ZETH_SUCCINCT=1``) waits for the
port's recursion slice: ``LocalProver.prove`` raises under
``ZETH_SUCCINCT=1`` rather than return another kind of receipt.

Python surface mirroring the reference's risc0-zkvm host API
(SURVEY.md §2.2: `ExecutorEnvBuilder`, `default_prover()`, dev-mode fake
receipts, `Receipt::verify(image_id)`, journal access).

Dev mode: set ``ZETH_DEV_MODE=1`` (the reference's RISC0_DEV_MODE) —
guests execute in the native emulator and a fake receipt is returned;
verification of fake receipts fails unless dev mode is active in the
verifying process too.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field

import numpy as np

from .convert import resolve_device
from .executor import Executor, compute_image_id
from .hash import poseidon2 as P2

DEFAULT_SEGMENT_PO2 = 20


def dev_mode_enabled() -> bool:
    return os.environ.get("ZETH_DEV_MODE", "0").lower() in ("1", "true", "yes")


def to_zkvm_input_bytes(obj) -> bytes:
    """Word-align serialized input (the reference's u32-word serde).
    Accepts bytes or str (JSON)."""
    raw = obj if isinstance(obj, bytes) else str(obj).encode()
    raw = len(raw).to_bytes(4, "little") + raw
    return raw + b"\x00" * (-len(raw) % 4)


def from_zkvm_input_bytes(data: bytes) -> bytes:
    n = int.from_bytes(data[:4], "little")
    return data[4:4 + n]


@dataclass
class ExecutorEnv:
    """Input + limits for one guest execution (ExecutorEnvBuilder analog)."""
    input_bytes: bytes = b""
    segment_limit_po2: int = DEFAULT_SEGMENT_PO2

    class Builder:
        def __init__(self):
            self._input = b""
            self._po2 = DEFAULT_SEGMENT_PO2

        def write(self, obj) -> "ExecutorEnv.Builder":
            self._input += to_zkvm_input_bytes(obj)
            return self

        def write_slice(self, raw: bytes) -> "ExecutorEnv.Builder":
            self._input += raw
            return self

        def segment_limit_po2(self, po2: int) -> "ExecutorEnv.Builder":
            self._po2 = po2
            return self

        def build(self) -> "ExecutorEnv":
            return ExecutorEnv(self._input, self._po2)

    @staticmethod
    def builder() -> "ExecutorEnv.Builder":
        return ExecutorEnv.Builder()


@dataclass
class ReceiptClaim:
    """Binding of an execution to its outputs (risc0-binfmt claim analog)."""
    image_id: np.ndarray         # (8,) field elements
    journal_digest: bytes        # sha256 of journal
    exit_code: int

    def digest(self) -> np.ndarray:
        ws = np.frombuffer(self.journal_digest, dtype="<u4").astype(np.uint64)
        halves = np.stack([ws & 0xFFFF, ws >> np.uint64(16)], -1).reshape(-1)
        row = np.concatenate([
            np.asarray(self.image_id, np.uint64), halves,
            np.array([self.exit_code], np.uint64)])
        return P2.hash_rows_np(row[None])[0]


class VerificationError(Exception):
    pass


@dataclass
class FakeInner:
    """Dev-mode inner receipt: no cryptographic content."""
    kind: str = "fake"


@dataclass
class SegmentsInner:
    """One STARK seal per execution segment (pre-recursion aggregation).

    Carries the public program image (bound to the claim's image ID at
    verification time — the rv32im circuit's ROM is built from it) and,
    when the guest used an accelerator, the accelerator batch seal whose
    proof-bound IO discharges the segments' claims of that kind (the
    reference's assumption-receipt/resolve role)."""
    seals: list = field(default_factory=list)       # list of np.uint32 seals
    paging_seals: list = field(default_factory=list)  # companion paging seals
    image_addrs: np.ndarray = None
    image_words: np.ndarray = None
    entry_pc: int = 0
    keccak_seal: np.ndarray = None
    bigint_seal: np.ndarray = None
    sha_seal: np.ndarray = None
    kind: str = "segments"


@dataclass
class Receipt:
    journal: bytes
    claim: ReceiptClaim
    inner: object

    def verify(self, image_id: np.ndarray, device=None) -> None:
        """Raise VerificationError unless the receipt proves an execution
        of `image_id` with this journal and exit code 0. The STARK
        verifies recompute their control roots on `device` (None: the
        CUDA card)."""
        image_id = np.asarray(image_id, dtype=np.uint64)
        if hashlib.sha256(self.journal).digest() != self.claim.journal_digest:
            raise VerificationError("journal digest mismatch")
        if not (self.claim.image_id == image_id).all():
            raise VerificationError("image id mismatch")
        if self.claim.exit_code != 0:
            raise VerificationError(f"guest exited with {self.claim.exit_code}")
        if isinstance(self.inner, FakeInner):
            if not dev_mode_enabled():
                raise VerificationError(
                    "fake receipt rejected: dev mode not enabled")
            return
        if isinstance(self.inner, SegmentsInner):
            from .circuits import rv32im as rv
            from .executor import image_id_from_parts
            # bind the prover-supplied program image to the claimed image ID
            got = image_id_from_parts(self.inner.entry_pc,
                                      self.inner.image_addrs,
                                      self.inner.image_words)
            if not (got == np.asarray(self.claim.image_id, np.uint64)).all():
                raise VerificationError("program image does not match image id")
            # resolve: an accelerator seal discharges the segments' claims
            acc_words, big_io, sha_io = _resolve_accelerators(self.inner,
                                                              device)
            out = rv.verify_segments(
                self.inner.seals, self.inner.paging_seals, self.claim,
                self.inner.image_addrs,
                self.inner.image_words, self.inner.entry_pc,
                keccak_checked=acc_words is not None,
                bigint_checked=big_io is not None,
                sha_checked=sha_io is not None, device=device)
            _check_accelerator_io(out, acc_words, big_io, sha_io)
            return
        raise VerificationError(f"unknown receipt kind: {self.inner!r}")


@dataclass
class SessionStats:
    user_cycles: int
    paging_cycles: int
    total_cycles: int
    keccak_calls: int
    segments: int


@dataclass
class ProveInfo:
    receipt: Receipt
    stats: SessionStats


def accelerator_words(kind: str, io) -> list[int]:
    """The proof-bound IO of a verified accelerator batch (what its
    ``verify_batch`` returns) as the segments' 32-bit word stream."""
    if kind == "keccak":
        return list(io)
    words = []
    if kind == "bigint":
        # a|b|m|r per op, 12 words each at the 384-bit accelerator width
        for a, b, m, r in io:
            for v in (a, b, m, r):
                words += [(v >> (32 * w)) & 0xFFFFFFFF for w in range(12)]
    else:
        for st, blk, outw in io:
            words += list(st) + list(blk) + list(outw)
    return words


def accelerator_module(kind: str):
    """The circuit module that proves and verifies batches of `kind`."""
    from .circuits import bigint2, keccak, sha256
    return {"keccak": keccak, "bigint": bigint2, "sha": sha256}[kind]


def _resolve_accelerators(inner, device=None):
    """Verify attached accelerator batch seals (the reference's resolve
    step): returns (keccak_io | None, bigint_io | None, sha_io | None)
    as the segments' 32-bit word streams."""
    out = []
    for kind, seal in (("keccak", inner.keccak_seal),
                       ("bigint", inner.bigint_seal),
                       ("sha", inner.sha_seal)):
        if seal is None:
            out.append(None)
            continue
        try:
            io = accelerator_module(kind).verify_batch(seal, device)
        except Exception as e:
            raise VerificationError(f"{kind} accelerator seal: {e}") from e
        out.append(accelerator_words(kind, io))
    return tuple(out)


def _check_accelerator_io(out, acc_words, big_io, sha_io=None):
    """The segments' bound IO streams must be prefixes of the proof-bound
    accelerator batches (batches may carry padding extras)."""
    if acc_words is not None:
        seg_words = out["keccak_words"]
        if acc_words[:len(seg_words)] != seg_words:
            raise VerificationError(
                "keccak accelerator IO does not match the segments' "
                "bound IO stream")
    if big_io is not None:
        seg_words = out["bigint_words"]
        if big_io[:len(seg_words)] != seg_words:
            raise VerificationError(
                "bigint accelerator IO does not match the segments' "
                "bound IO stream")
    if sha_io is not None:
        seg_words = out["sha_words"]
        if sha_io[:len(seg_words)] != seg_words:
            raise VerificationError(
                "sha accelerator IO does not match the segments' "
                "bound IO stream")


def bigint_ops(inputs) -> list:
    """The executor's bigint inputs ((n, 48) 32-bit words per call:
    a|b|m|r, 12 little-endian words each) -> [(a, b, m)] big ints."""
    rows = np.asarray(inputs, np.uint64).astype("<u4")
    return [tuple(int.from_bytes(row[12 * j:12 * j + 12].tobytes(), "little")
                  for j in range(3)) for row in rows]


def accelerator_batches(ex) -> dict:
    """The accelerator batches of one execution (an ``Executor`` after
    ``run``), as ``prove_batch`` takes them: kind -> arguments, for each
    kind of accelerator call the guest made."""
    out = {}
    if len(ex.keccak_inputs):
        out["keccak"] = (ex.keccak_inputs,)
    if len(ex.bigint_inputs):
        out["bigint"] = (bigint_ops(ex.bigint_inputs),)
    if len(ex.sha_inputs):
        rows = np.asarray(ex.sha_inputs, np.uint64)
        out["sha"] = (rows[:, :8], rows[:, 8:24])
    return out


class DevModeProver:
    """Executes the guest natively; returns a fake receipt (dev-mode seam —
    the reference's fake-backend test strategy, SURVEY.md §4)."""

    name = "dev-mode"

    def prove(self, env: ExecutorEnv, elf: bytes) -> ProveInfo:
        ex = Executor(elf, env.input_bytes, segment_po2=env.segment_limit_po2)
        res = ex.run()
        claim = ReceiptClaim(
            image_id=compute_image_id(elf),
            journal_digest=hashlib.sha256(res.journal).digest(),
            exit_code=res.exit_code)
        receipt = Receipt(journal=res.journal, claim=claim, inner=FakeInner())
        stats = SessionStats(
            user_cycles=res.user_cycles, paging_cycles=res.paging_cycles,
            total_cycles=res.total_cycles, keccak_calls=res.keccak_calls,
            segments=len(res.segments))
        return ProveInfo(receipt=receipt, stats=stats)


class LocalProver:
    """Executes, then STARK-proves every segment and every accelerator
    batch on `device` (None: the CUDA card; without one ``prove``
    raises). The receipt carries the per-segment seals."""

    name = "local"

    def __init__(self, device=None):
        self.device = device

    def prove(self, env: ExecutorEnv, elf: bytes) -> ProveInfo:
        from .circuits import rv32im as rv
        from .executor import load_image
        device = resolve_device(self.device)
        if os.environ.get("ZETH_SUCCINCT", "0") == "1":
            raise NotImplementedError(
                "ZETH_SUCCINCT=1: the succinct receipt (recursion lift/join) "
                "is not ported yet; it waits for the port's recursion slice")
        entry_pc, img_a, img_w = load_image(elf)
        ex = Executor(elf, env.input_bytes,
                      segment_po2=env.segment_limit_po2, trace=True)
        res = ex.run()
        claim = ReceiptClaim(
            image_id=compute_image_id(elf),
            journal_digest=hashlib.sha256(res.journal).digest(),
            exit_code=res.exit_code)
        seals, paging_seals = rv.prove_segments(res.segments, img_a, img_w,
                                                device=device)
        accel = {kind: accelerator_module(kind).prove_batch(
                     *args, device=device)[0]
                 for kind, args in accelerator_batches(ex).items()}
        inner = SegmentsInner(seals=seals, paging_seals=paging_seals,
                              image_addrs=img_a,
                              image_words=img_w, entry_pc=entry_pc,
                              keccak_seal=accel.get("keccak"),
                              bigint_seal=accel.get("bigint"),
                              sha_seal=accel.get("sha"))
        receipt = Receipt(journal=res.journal, claim=claim, inner=inner)
        stats = SessionStats(
            user_cycles=res.user_cycles, paging_cycles=res.paging_cycles,
            total_cycles=res.total_cycles, keccak_calls=res.keccak_calls,
            segments=len(res.segments))
        return ProveInfo(receipt=receipt, stats=stats)


def default_prover(device=None):
    """Dispatch on environment (the reference's default_prover() seam)."""
    if dev_mode_enabled():
        return DevModeProver()
    return LocalProver(device)
