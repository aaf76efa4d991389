"""zkVM host API: executor env, prover dispatch, receipts.

Counterpart of ``zeth_tpu.zkvm``, a jax-free copy: ``LocalProver`` proves
every segment (rv32im + paging) and the accelerator batches on `device`
(None: the CUDA card). Without ``ZETH_SUCCINCT=1`` the receipt carries
those seals, and ``Receipt.verify`` runs the STARK verifies, the chain
checks and the accelerator resolve. With ``ZETH_SUCCINCT=1`` every
(segment, paging) pair and every accelerator batch is lifted into the
recursion circuit and joined to one root proof (``SuccinctInner``), and
``Receipt.verify`` checks that one STARK, the claim hashing and the
chain. Both recompute the control roots on `device`.

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
class SuccinctInner:
    """ONE root recursion proof for the whole execution (post lift/join).

    The per-segment publics travel in the clear (they are public); each
    is bound to a lift claim digest, folded up the in-circuit join tree
    to the root proof's 8-element public claim — so verification costs
    ONE STARK verify plus cheap host hashing/chain replay, independent of
    segment count (the reference's succinct receipt, SURVEY.md §2.2
    risc0-circuit-recursion)."""
    root_seal: np.ndarray           # encoded recursion StarkProof
    segment_publics: list           # [segment][...] public values
    segment_po2s: list              # [segment] inner trace po2
    # companion paging bindings, pinned by the pair-joined lift claims
    # (no paging seals travel — the root proof verified them in-circuit)
    segment_extras: list = None     # [(pg_root, d0, d1, g4, g5)]
    paging_po2s: list = None
    paging_publics: list = None
    image_addrs: np.ndarray = None
    image_words: np.ndarray = None
    entry_pc: int = 0
    # in-circuit resolve (reference: recursion "resolve" programs): the
    # accelerator batch proofs were LIFTED into the root fold, so only
    # their claim-pinned publics travel — no accelerator seals, no
    # host-side accelerator STARK verification at receipt time
    accel_publics: list = None      # [(kind, po2, publics ints)]
    kind: str = "succinct"


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
            # a dev-mode receipt needs no card; a real one resolves its
            # device before any seal is read, so a missing card raises
            # instead of reading as a rejected receipt
            device = resolve_device(device)
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
        if isinstance(self.inner, SuccinctInner):
            _verify_succinct(self.inner, self.claim, resolve_device(device))
            return
        raise VerificationError(f"unknown receipt kind: {self.inner!r}")


def _verify_succinct(inner, claim, device) -> None:
    """The succinct branch of ``Receipt.verify``: ONE root STARK on
    `device`, the host claim hashing, then the chain checks."""
    from .circuits import rv32im as rv
    from .circuits.paging import PagingAir
    from .executor import image_id_from_parts
    from .recursion import succinct
    from .zkp import proof as proof_mod
    from .zkp import verifier as verifier_mod
    got = image_id_from_parts(inner.entry_pc, inner.image_addrs,
                              inner.image_words)
    if not (got == np.asarray(claim.image_id, np.uint64)).all():
        raise VerificationError("program image does not match image id")
    air = rv.Rv32imAir(inner.image_addrs, inner.image_words)
    # succinct paging resolve: the (segment, paging) lift pairs were
    # joined in-circuit — the root claim pins every segment proof, its
    # paging proof (via the shared paging main root), and the
    # cross-bound d0/d1/g4/g5. Verification is ONE root STARK + host
    # claim hashing; the page-tree roots then chain in verify_chain below.
    pg_air = PagingAir()
    if not (len(inner.segment_publics)
            == len(inner.segment_extras or [])
            == len(inner.paging_po2s or [])
            == len(inner.paging_publics or [])):
        raise VerificationError(
            "succinct receipt: paging binding count mismatch")
    paging_pubs_list = [[int(p) for p in ps] for ps in inner.paging_publics]
    accel = []
    seen_kinds = set()
    for kind, a_po2, a_pub in (inner.accel_publics or []):
        if kind not in ("keccak", "bigint", "sha"):
            raise VerificationError(
                f"unknown accelerator claim kind {kind!r}")
        if kind in seen_kinds:
            # one batch per kind (prover contract): a duplicate would
            # silently shadow the first IO stream below
            raise VerificationError(
                f"duplicate accelerator claim kind {kind!r}")
        seen_kinds.add(kind)
        accel.append((accelerator_air(kind), a_po2, [int(p) for p in a_pub]))
    try:
        # a malformed seal fails to decode: rejected like a bad proof
        root_proof = proof_mod.decode(inner.root_seal)
        root = succinct.RecReceipt(
            proof=root_proof, claim=np.asarray(root_proof.publics, np.uint64),
            node=None)
        succinct.verify_root_segments(
            root, air, inner.segment_po2s, inner.segment_publics,
            inner.segment_extras, pg_air, inner.paging_po2s,
            paging_pubs_list, [x[0] for x in inner.segment_extras],
            accel=accel, device=device)
    except (verifier_mod.VerificationError, ValueError, AssertionError) as e:
        raise VerificationError(f"succinct receipt: {e}") from e
    # in-circuit resolve: the root proof already verified every
    # accelerator batch; extract the claim-pinned IO streams from the
    # publics (no accelerator STARK checks here)
    io = {}
    try:
        for kind, a_po2, a_pub in (inner.accel_publics or []):
            io[kind] = accelerator_words(
                kind, accelerator_module(kind).parse_publics(a_pub))
    except ValueError as e:
        raise VerificationError(f"accelerator claim publics: {e}") from e
    out = rv.verify_chain(
        inner.segment_publics, claim, inner.image_addrs, inner.image_words,
        inner.entry_pc, paging_publics_list=paging_pubs_list,
        keccak_checked="keccak" in io, bigint_checked="bigint" in io,
        sha_checked="sha" in io)
    _check_accelerator_io(out, io.get("keccak"), io.get("bigint"),
                          io.get("sha"))


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


def accelerator_air(kind: str):
    """The AIR of `kind`'s batch proofs."""
    from .circuits import bigint2, keccak, sha256
    return {"keccak": keccak.KeccakAir, "bigint": bigint2.Bigint2Air,
            "sha": sha256.Sha256Air}[kind]()


def _resolve_accelerators(inner, device=None):
    """Verify attached accelerator batch seals (the reference's resolve
    step): returns (keccak_io | None, bigint_io | None, sha_io | None)
    as the segments' 32-bit word streams. Only the seal's own failures
    read as a rejection; a device error (no card, out of memory, a
    failed kernel build) propagates."""
    from .zkp import verifier as verifier_mod
    out = []
    for kind, seal in (("keccak", inner.keccak_seal),
                       ("bigint", inner.bigint_seal),
                       ("sha", inner.sha_seal)):
        if seal is None:
            out.append(None)
            continue
        try:
            io = accelerator_module(kind).verify_batch(seal, device)
        except (verifier_mod.VerificationError, ValueError,
                AssertionError) as e:
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
    raises).

    With ZETH_SUCCINCT=1, additionally lifts every (segment, paging) pair
    and every accelerator batch into the recursion circuit and joins them
    to ONE root proof on `device` (succinct receipt); otherwise the
    receipt carries the per-segment seals."""

    name = "local"

    def __init__(self, device=None):
        self.device = device

    def prove(self, env: ExecutorEnv, elf: bytes) -> ProveInfo:
        from .circuits import rv32im as rv
        from .executor import load_image
        device = resolve_device(self.device)
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
        if os.environ.get("ZETH_SUCCINCT", "0") == "1":
            inner = _succinct_inner(seals, paging_seals, accel, img_a, img_w,
                                    entry_pc, device)
        else:
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


def paging_extras(pg_proof) -> tuple:
    """The companion bindings a segment's lift claim pins, read from its
    paging proof: (paging main root, d0, d1, g4, g5)."""
    from .circuits.paging import PagingAir
    ppg = PagingAir.parse_publics([int(p) for p in pg_proof.publics])
    return (np.asarray(pg_proof.roots["main"], np.uint64),
            ppg["d0"], ppg["d1"], ppg["g4"], ppg["g5"])


def _succinct_inner(seals, paging_seals, accel_seals, img_a, img_w,
                    entry_pc, device) -> SuccinctInner:
    """Lift every (segment, paging) pair and accelerator batch on
    `device` and join them to ONE root proof."""
    from .circuits.paging import PagingAir
    from .circuits.rv32im import Rv32imAir
    from .recursion import succinct
    from .zkp import proof as proof_mod
    proofs = [proof_mod.decode(s) for s in seals]
    pg_proofs = [proof_mod.decode(s) for s in paging_seals]
    extras = [paging_extras(pg) for pg in pg_proofs]
    # in-circuit resolve: lift the accelerator batch proofs into the
    # fold (their publics get claim-pinned; seals dropped)
    accel, accel_publics = [], []
    for kind in ("keccak", "bigint", "sha"):
        if kind not in accel_seals:
            continue
        pf = proof_mod.decode(accel_seals[kind])
        accel.append((accelerator_air(kind), pf))
        accel_publics.append((kind, pf.po2, [int(p) for p in pf.publics]))
    root = succinct.aggregate_segments(
        Rv32imAir(img_a, img_w), proofs, PagingAir(), pg_proofs, extras,
        accel=accel, device=device)
    return SuccinctInner(
        root_seal=proof_mod.encode(root.proof),
        segment_publics=[[int(p) for p in pf.publics] for pf in proofs],
        segment_po2s=[pf.po2 for pf in proofs],
        segment_extras=extras,
        paging_po2s=[pf.po2 for pf in pg_proofs],
        paging_publics=[[int(p) for p in pf.publics] for pf in pg_proofs],
        image_addrs=img_a, image_words=img_w, entry_pc=entry_pc,
        accel_publics=accel_publics)


def default_prover(device=None):
    """Dispatch on environment (the reference's default_prover() seam)."""
    if dev_mode_enabled():
        return DevModeProver()
    return LocalProver(device)
