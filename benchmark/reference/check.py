"""What decides ``correct``: each seal verified, each bound claim compared.

Every function returns the counts that the harness holds to their limits
(exact comparisons, limit 0):

* ``seals_rejected`` -- seals the frozen verifier (``zkp.verifier``)
  rejects: the Merkle openings of every group (whose leaves the program's
  leaf kernel hashed), the control root worked out again here, the
  DEEP-ALI identity at z (the constraints of the frozen AIR), the DEEP
  combination and FRI, and for a segment the binding of its paging proof
  (main root mixed in, g4/g5 and d0/d1 shared).
* ``claims_wrong`` -- values of the claims those seals bind that differ
  from what this package works out from the same inputs.

Everything a claim is held to is worked out here from the benchmark's
inputs: the ELF's image and its page root, the segment's execution
(``rv32``: exit state, journal, the memory it wrote and so the post-state
page root, its cycles), keccak-f, SHA-256, the bigint products, the
claims digests. The guest ELF and its input bytes are the program's
build and encoding of the fixture block, taken as given; a halting
segment's journal is held to the block hash the fixture is named by.
"""

from __future__ import annotations

import numpy as np

from . import elf, keccakf, rv32, sha256, sponge
from .circuits import keccak as keccak_air
from .circuits import paging, rv32im
from .hash import pagetree
from .zkp import proof as proof_mod
from .zkp import verifier


def image_of(elf_bytes: bytes) -> dict:
    """The image a segment proof must start from: entry pc, the image's
    words and its page root, and the rv32im AIR over it."""
    entry, addrs, words = elf.load_image(elf_bytes)
    return {"entry": entry, "addrs": addrs, "words": words,
            "root": pagetree.SparsePageTree(addrs, words).root(),
            "air": rv32im.Rv32imAir(addrs, words)}


# what a malformed seal raises: the verifier turns every structural fault
# of a proof into VerificationError; the decoder raises ValueError or
# AssertionError. Anything else is a fault of the reference, and raises.
DECODE_ERRORS = (ValueError, AssertionError)


def _verified(fn) -> bool:
    try:
        fn()
    except verifier.VerificationError as e:
        print(f"[reference] rejected: {type(e).__name__}: {e}")
        return False
    return True


def _decoded(seal):
    """The proof a seal encodes, or None where it is malformed."""
    try:
        return proof_mod.decode(seal)
    except DECODE_ERRORS as e:
        print(f"[reference] rejected: seal unreadable: {e}")
        return None


def _accelerator_io_wrong(pp: dict) -> list:
    """Names of the accelerator calls whose bound results differ from
    keccak-f, a*b mod m and the SHA-256 compression over their bound
    operands."""
    wrong = []
    kw = pp["keccak_words"]
    if len(kw) % 100:
        return ["keccak_io_length"]
    if kw:
        calls = np.array(kw, np.uint64).reshape(-1, 2, 25, 2)
        lanes = calls[..., 0] | (calls[..., 1] << np.uint64(32))
        if not (keccakf.permute(lanes[:, 0]) == lanes[:, 1]).all():
            wrong.append("keccak_io")
    bw = pp["bigint_words"]
    if len(bw) % 48:
        return wrong + ["bigint_io_length"]
    for c in range(0, len(bw), 48):
        a, b, m, r = (sum(bw[c + 12 * j + w] << (32 * w) for w in range(12))
                      for j in range(4))
        if m == 0 or r != a * b % m:
            wrong.append("bigint_io")
            break
    sw = pp["sha_words"]
    if len(sw) % 32:
        return wrong + ["sha_io_length"]
    for c in range(0, len(sw), 32):
        if sha256.compress(sw[c:c + 8], sw[c + 8:c + 24]) != sw[c + 24:c + 32]:
            wrong.append("sha_io")
            break
    return wrong


def execute(image: dict, input_bytes: bytes, po2: int) -> dict:
    """The first segment of the guest in `image` on `input_bytes`, at
    segment po2 `po2`, worked out by ``rv32``; with ``post_root``, the
    page root of memory as the segment leaves it."""
    run = rv32.run_segment(image["entry"], image["addrs"], image["words"],
                           input_bytes, po2)
    after = pagetree.SparsePageTree(image["addrs"], image["words"])
    for a, v in run["written"].items():
        after.set_word(a, v)
    run["post_root"] = after.root()
    return run


def check_segment(seal, pg_seal, image: dict, run: dict, block_hash: bytes,
                  cycles: int, device) -> tuple[int, list]:
    """(1 if the pair of seals is rejected else 0, names of the claim
    values that differ) for the first segment of an execution.

    run: ``execute``'s segment, which the proof must claim; block_hash:
    what a halting segment of the stateless-client guest commits as its
    journal; cycles: the user cycles the program counted for the segment
    (the work the throughput metric counts)."""
    pf, pg = _decoded(seal), _decoded(pg_seal)
    if pf is None or pg is None:
        return 1, ["publics"]
    pubs = [int(p) for p in pf.publics]
    pg_pubs = [int(p) for p in pg.publics]
    try:
        pp = rv32im.parse_publics(pubs)
        ppg = paging.PagingAir.parse_publics(pg_pubs)
    except ValueError as e:
        print(f"[reference] rejected: claim unreadable: {e}")
        return 1, ["publics"]

    def both():
        verifier.verify(paging.PagingAir(), pg, pg_pubs, device=device)
        sampled = verifier.verify(
            image["air"], pf, pubs,
            derived_extra={"d0": ppg["d0"], "d1": ppg["d1"]},
            extra_mix=pg.roots["main"], device=device)
        if not ((np.asarray(sampled[4], np.uint64) == ppg["g4"]).all()
                and (np.asarray(sampled[5], np.uint64) == ppg["g5"]).all()):
            raise verifier.VerificationError(
                "paging proof's g4/g5 differ from the rv32im transcript's")

    rejected = 0 if _verified(both) else 1
    journal = b"".join(int(w).to_bytes(4, "little")
                       for w in pp["journal_words"])
    checks = {
        "entry_pc": pp["entry_pc"] == image["entry"],
        "entry_regs": pp["entry_regs"] == [0] * 32,
        "pre_root": (ppg["pre_root"] == image["root"]).all(),
        "exit_pc": pp["exit_pc"] == run["exit_pc"],
        "exit_regs": pp["exit_regs"] == run["exit_regs"],
        "halted": bool(pp["halted"]) == run["halted"],
        "exit_code": pp["exit_code"] == run["exit_code"],
        "post_root": (ppg["post_root"] == run["post_root"]).all(),
        "journal": journal == run["journal"],
        "block_hash": not run["halted"] or run["journal"] == block_hash,
        "cycles": int(cycles) == run["user_cycles"],
    }
    wrong = [k for k, ok in checks.items() if not ok]
    return rejected, wrong + _accelerator_io_wrong(pp)


def io_words(states: np.ndarray) -> np.ndarray:
    """The (n, 100) IO words a keccak batch's claim binds: per
    permutation its 25 input lanes then its 25 output lanes, each lane as
    (low, high) 32-bit words."""
    lanes = np.concatenate([states, keccakf.permute(states)], axis=1)
    return np.stack([lanes & np.uint64(0xFFFFFFFF),
                     lanes >> np.uint64(32)], axis=-1).reshape(len(states), -1)


def claims_digests(words: list) -> list:
    """The claims digest of each batch's IO words: the Poseidon2 sponge of
    their 16-bit limbs, low limb first. All rows hash together, so rows
    of one length go in one call."""
    limbs = np.stack([np.stack([w & np.uint64(0xFFFF), w >> np.uint64(16)],
                               axis=-1).reshape(-1) for w in words])
    return list(sponge.sponge(limbs))


def check_keccak_batch(seal, states: np.ndarray,
                       device) -> tuple[int, list, np.ndarray]:
    """(1 if the seal is rejected else 0, names of the claim values that
    differ, the reference's IO words) for one batch of keccak-f inputs."""
    want = io_words(states)
    pf = _decoded(seal)
    if pf is None:
        return 1, ["publics"], want
    pubs = [int(p) for p in pf.publics]
    rejected = 0 if _verified(lambda: verifier.verify(
        keccak_air.KeccakAir(), pf, pubs, device=device)) else 1
    wrong = []
    try:
        got = np.array(keccak_air.parse_publics(pubs), np.uint64)
    except ValueError as e:
        print(f"[reference] claim unreadable: {e}")
        return rejected, wrong + ["publics"], want
    if got.shape != (want.size,):
        wrong.append("permutations")
    else:
        got = got.reshape(want.shape)
        if not (got[:, :50] == want[:, :50]).all():
            wrong.append("inputs")
        if not (got[:, 50:] == want[:, 50:]).all():
            wrong.append("outputs")
    return rejected, wrong, want
