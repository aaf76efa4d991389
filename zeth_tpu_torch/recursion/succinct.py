"""Succinct receipts: cryptographic lift / join over the recursion VM.

The role of risc0-circuit-recursion's lift/join/resolve programs
(SURVEY.md §2.2, §3.2 RECURSION step), TPU-first: each lift proves — with
the framework's own STARK prover over the recursion-VM AIR — that one
inner segment seal verifies; each join proves that two child recursion
proofs verify. The final receipt is ONE recursion proof whose 8-element
public claim is the root of a Poseidon2 claim tree over the per-segment
claims, so Receipt.verify checks a single seal regardless of segment
count (VERDICT.md r1 "What's missing" #3).

Claim structure (host mirrors in this module, in-circuit binding in
recursion/compiler.py):

  lift claim  = H(po2 || H(segment publics))        (claim_digest)
  join claim  = H(left claim row || right claim row) (join_claim)

The *programs* are pinned by their control roots: a lift program bakes
the inner AIR's control root as constants; a join program bakes its two
children's (recursion-AIR) control roots. Verifying the root proof
therefore transitively pins every seal down to the segment circuits.

Port note: a jax-free copy of ``zeth_tpu.recursion.succinct``. Every entry
point takes ``device`` (None: the CUDA card; without one it raises) and
passes it to the prover, the verifier, the control roots and the claim
digests. The program caches are keyed as in the reference. With the
prover's ``TIMING`` on, the host compile and the interpreter are timed
in ``prover.STAGE_LOG`` beside the prover's own stages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..convert import resolve_device
from ..hash import poseidon2 as P2
from ..zkp import prover as prover_mod
from ..zkp import verifier as verifier_mod
from . import compiler, vm
from .builder import Builder


def join_claim(left8: np.ndarray, right8: np.ndarray) -> np.ndarray:
    """Host mirror of the join program's outer claim."""
    row = np.concatenate([np.asarray(left8, np.uint64),
                          np.asarray(right8, np.uint64)])
    return P2.hash_rows_np(row[None])[0]


@dataclass
class JoinProgram:
    """Verifier program for TWO child recursion proofs."""
    program: vm.Program
    left: compiler.VerifierProgram      # shape info of each child proof
    right: compiler.VerifierProgram

    def air(self) -> vm.RecursionAir:
        return vm.RecursionAir(self.program)


# in-memory program caches (programs are deterministic in their keys)
_LIFT_CACHE: dict = {}
_JOIN_CACHE: dict = {}


def publics_shape(air, publics):
    """Shape token distinguishing list splits in same-length publics."""
    hook = getattr(air, "publics_shape", None)
    return hook(publics) if hook else None


def lift_program(inner_air, po2: int, n_publics: int, pub_shape=None,
                 device=None) -> compiler.VerifierProgram:
    """The (cached) lift program of proofs of this shape; the inner
    control root is committed on `device` (None: the CUDA card)."""
    key = (inner_air.name, po2, n_publics, pub_shape)
    vp = _LIFT_CACHE.get(key)
    if vp is None:
        with prover_mod._Stage("recursion compile (host)"):
            vp = compiler.compile_verifier(inner_air, po2, n_publics,
                                           pub_shape=pub_shape,
                                           device=resolve_device(device))
        _LIFT_CACHE[key] = vp
    return vp


def _rec_shape(vp) -> compiler.VerifierProgram:
    """The VerifierProgram describing proofs *of* vp's own program (i.e.
    the shape a parent join must verify)."""
    air = vp.air()
    po2 = vp.program.po2()
    domains, deg_fin, _, _ = compiler._fri_layout(po2)
    return compiler.VerifierProgram(
        program=vp.program, air_name=air.name, po2=po2,
        n_publics=vm.N_PUB,
        group_widths={"control": vm.CL.N, "main": vm.ML.N,
                      "aux": vm.AL.N, "check": 16},
        n_taps=2 * (vm.CL.N + vm.ML.N + vm.AL.N) + 16,
        layer_domains=domains, final_degree=deg_fin, depth=po2 + 2)


def join_program(left_vp, right_vp, device=None) -> JoinProgram:
    """Compile (cached) the join program verifying one proof of each
    child program, binding H(left_claim || right_claim). The children's
    control roots are committed on `device` (None: the CUDA card)."""
    lkey = left_vp.program.digest()
    rkey = right_vp.program.digest()
    jp = _JOIN_CACHE.get((lkey, rkey))
    if jp is not None:
        return jp
    device = resolve_device(device)
    with prover_mod._Stage("recursion compile (host)"):
        b = Builder()
        shapes = []
        pubs = []
        for child in (left_vp, right_vp):
            air = child.air()
            po2 = child.program.po2()
            root = compiler.expected_control_root(air, po2, device)
            pubs.append(compiler.emit_verify(b, air, po2, vm.N_PUB,
                                             control_root=root))
            shapes.append(_rec_shape(child))
        claim = b.sponge_hash(pubs[0] + pubs[1])
        for j in range(vm.N_PUB):
            b.bind_public(claim[j], j)
        jp = JoinProgram(program=b.build(), left=shapes[0], right=shapes[1])
    _JOIN_CACHE[(lkey, rkey)] = jp
    return jp


# ---------------------------------------------------------------------------
# Proving
# ---------------------------------------------------------------------------


@dataclass
class RecReceipt:
    """One recursion proof + its public claim (and the node's program)."""
    proof: object                 # StarkProof over the recursion AIR
    claim: np.ndarray             # (8,) = proof.publics
    node: object                  # VerifierProgram (lift) | JoinProgram


def _prove_program(program: vm.Program, stream: np.ndarray,
                   claim: np.ndarray, node, device) -> RecReceipt:
    assert stream.shape[0] == program.n_stream, \
        f"stream {stream.shape[0]} != program {program.n_stream}"
    air = vm.RecursionAir(program)
    with prover_mod._Stage("recursion witgen (host, native)"):
        main, wom = air.witgen(stream)
    publics = [int(x) for x in claim]
    with prover_mod._Stage("recursion prove", device):
        proof = prover_mod.prove(air, main, publics, device=device)
    return RecReceipt(proof=proof, claim=np.asarray(claim, np.uint64),
                      node=node)


def _extra_row(extra):
    """(root8, d0, d1, g4, g5) -> the 24-value claim row."""
    root, d0, d1, g4, g5 = extra
    return np.concatenate([np.asarray(root, np.uint64).reshape(8),
                           np.asarray(d0, np.uint64).reshape(4),
                           np.asarray(d1, np.uint64).reshape(4),
                           np.asarray(g4, np.uint64).reshape(4),
                           np.asarray(g5, np.uint64).reshape(4)])


def lift(inner_air, inner_proof, extra=None, device=None) -> RecReceipt:
    """Prove in-circuit that inner_proof verifies on `device` (None: the
    CUDA card); returns the receipt.

    extra: for uses_extra_mix inner AIRs (rv32im), the companion paging
    bindings (paging_main_root(8,), d0(4,), d1(4,), g4(4,), g5(4,)) —
    bound into the lift claim and resolved against the paging proof's
    publics at the receipt level."""
    device = resolve_device(device)
    vp = lift_program(inner_air, inner_proof.po2, len(inner_proof.publics),
                      publics_shape(inner_air, inner_proof.publics), device)
    if getattr(inner_air, "uses_extra_mix", False):
        assert extra is not None, "inner AIR requires companion bindings"
        stream = compiler.proof_to_stream(
            vp, inner_proof, extra=(extra[0], extra[1], extra[2]))
        claim = compiler.claim_digest(inner_proof.po2, inner_proof.publics,
                                      _extra_row(extra), device)
    else:
        stream = compiler.proof_to_stream(vp, inner_proof)
        row = (np.asarray(inner_proof.roots["main"], np.uint64)
               if getattr(inner_air, "bind_claim_main_root", False)
               else None)
        claim = compiler.claim_digest(inner_proof.po2, inner_proof.publics,
                                      row, device)
    return _prove_program(vp.program, stream, claim, vp, device)


def join(left: RecReceipt, right: RecReceipt, device=None) -> RecReceipt:
    """Prove in-circuit on `device` (None: the CUDA card) that both
    children's proofs verify."""
    device = resolve_device(device)
    jp = join_program(left.node, right.node, device)
    stream = np.concatenate([
        compiler.proof_to_stream(jp.left, left.proof),
        compiler.proof_to_stream(jp.right, right.proof)])
    claim = join_claim(left.claim, right.claim)
    return _prove_program(jp.program, stream, claim, jp, device)


def aggregate(inner_air, inner_proofs: list, extras=None,
              device=None) -> RecReceipt:
    """lift every segment proof, then fold joins to a single receipt."""
    device = resolve_device(device)
    if extras is None:
        extras = [None] * len(inner_proofs)
    nodes = [lift(inner_air, p, extra=x, device=device)
             for p, x in zip(inner_proofs, extras)]
    return _fold(nodes, device)


def _fold(nodes: list, device) -> RecReceipt:
    while len(nodes) > 1:
        nxt = []
        for i in range(0, len(nodes) - 1, 2):
            nxt.append(join(nodes[i], nodes[i + 1], device))
        if len(nodes) % 2:
            nxt.append(nodes[-1])
        nodes = nxt
    return nodes[0]


def aggregate_segments(inner_air, inner_proofs: list, paging_air,
                       paging_proofs: list, extras: list,
                       accel: list = None, device=None) -> RecReceipt:
    """Lift every (segment, paging) proof pair, join each pair, then
    fold to ONE root receipt. The segment lift's claim binds (paging
    main root, d0/d1, sampled g4/g5); the paging lift's claim binds the
    paging proof's own main root — so the root claim transitively pins
    the cross-proof link, and receipt verification needs no per-segment
    STARK checks at all (only the root proof + host hashing).

    accel: optional [(air, proof)] accelerator batch proofs (keccak /
    bigint / sha) — each is lifted and appended to the fold (the
    reference's in-circuit RESOLVE: the root claim then pins the
    accelerator publics, so receipt verification discharges the
    segments' RLC-bound IO against claim-pinned public streams with no
    host-side accelerator STARK verification). Everything is proved on
    `device` (None: the CUDA card)."""
    device = resolve_device(device)
    pairs = []
    for p, pg, x in zip(inner_proofs, paging_proofs, extras):
        pairs.append(join(lift(inner_air, p, extra=x, device=device),
                          lift(paging_air, pg, device=device), device))
    for a_air, a_proof in (accel or []):
        pairs.append(lift(a_air, a_proof, device=device))
    return _fold(pairs, device)


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------


def expected_root_claim(inner_po2s: list, inner_publics: list,
                        extras=None, device=None) -> np.ndarray:
    """Fold the claim tree exactly as aggregate() does; the publics'
    digests are hashed on `device` (None: the CUDA card)."""
    device = resolve_device(device)
    if extras is None:
        extras = [None] * len(inner_po2s)
    claims = [compiler.claim_digest(
                  p, pub, None if x is None else _extra_row(x), device)
              for p, pub, x in zip(inner_po2s, inner_publics, extras)]
    return _fold_claims(claims)


def _fold_programs(nodes: list, device):
    while len(nodes) > 1:
        nxt = [join_program(nodes[i], nodes[i + 1], device)
               for i in range(0, len(nodes) - 1, 2)]
        if len(nodes) % 2:
            nxt.append(nodes[-1])
        nodes = nxt
    return nodes[0]


def _fold_claims(claims: list) -> np.ndarray:
    while len(claims) > 1:
        nxt = []
        for i in range(0, len(claims) - 1, 2):
            nxt.append(join_claim(claims[i], claims[i + 1]))
        if len(claims) % 2:
            nxt.append(claims[-1])
        claims = nxt
    return claims[0]


def verify_root(receipt: RecReceipt, inner_air, inner_po2s: list,
                inner_publics: list, extras=None, device=None) -> None:
    """Verify ONE root recursion proof against the claimed segment publics.

    Recompiles (cached) the program tree for the claimed shapes so the
    root proof's control root is pinned to the full lift/join structure;
    then checks the root claim equals the fold of the per-segment claim
    digests. Raises zkp.verifier.VerificationError on failure. The
    control roots and claim digests are computed on `device` (None: the
    CUDA card).
    """
    device = resolve_device(device)
    want = expected_root_claim(inner_po2s, inner_publics, extras, device)
    if not (np.asarray(receipt.claim, np.uint64) == want).all():
        raise verifier_mod.VerificationError("root claim mismatch")
    # rebuild the expected root program for the claimed shapes
    nodes = [lift_program(inner_air, p, len(pub),
                          publics_shape(inner_air, pub), device)
             for p, pub in zip(inner_po2s, inner_publics)]
    root_air = _fold_programs(nodes, device).air()
    verifier_mod.verify(root_air, receipt.proof,
                        [int(x) for x in receipt.claim], device=device)


def verify_root_segments(receipt: RecReceipt, inner_air, inner_po2s,
                         inner_publics, extras, paging_air, paging_po2s,
                         paging_publics, paging_roots,
                         accel: list = None, device=None) -> None:
    """verify_root for the (segment, paging) pair tree built by
    aggregate_segments: checks the root claim against the fold of the
    pair-joined claim digests — each segment claim bound to its paging
    claim via the shared paging main root — then verifies the ONE root
    STARK against the recompiled pair-tree program.

    accel: optional [(air, po2, publics)] accelerator batch claims that
    were lifted into the fold (in-circuit resolve) — their claim
    digests join the fold after the segment pairs. The control roots
    and claim digests are computed on `device` (None: the CUDA card)."""
    device = resolve_device(device)
    if not (len(inner_po2s) == len(inner_publics) == len(extras)
            == len(paging_po2s) == len(paging_publics)
            == len(paging_roots)):
        raise verifier_mod.VerificationError("pair-tree shape mismatch")
    claims = []
    for po2, pub, x, ppo2, ppub, proot in zip(
            inner_po2s, inner_publics, extras, paging_po2s,
            paging_publics, paging_roots):
        if not (np.asarray(x[0], np.uint64)
                == np.asarray(proot, np.uint64)).all():
            raise verifier_mod.VerificationError(
                "segment claim's paging root does not match the paging "
                "proof's main root")
        ppg = paging_air.parse_publics(ppub)
        for xi, key in ((1, "d0"), (2, "d1"), (3, "g4"), (4, "g5")):
            if not (np.asarray(x[xi], np.uint64) == ppg[key]).all():
                raise verifier_mod.VerificationError(
                    f"segment claim's {key} does not match the paging "
                    "proof's publics")
        seg_claim = compiler.claim_digest(po2, pub, _extra_row(x), device)
        pg_claim = compiler.claim_digest(
            ppo2, ppub, np.asarray(proot, np.uint64).reshape(8), device)
        claims.append(join_claim(seg_claim, pg_claim))
    for a_air, a_po2, a_pub in (accel or []):
        claims.append(compiler.claim_digest(a_po2, a_pub, None, device))
    want = _fold_claims(claims)
    if not (np.asarray(receipt.claim, np.uint64) == want).all():
        raise verifier_mod.VerificationError("root claim mismatch")
    nodes = []
    for po2, pub, ppo2, ppub in zip(inner_po2s, inner_publics,
                                    paging_po2s, paging_publics):
        seg_vp = lift_program(inner_air, po2, len(pub),
                              publics_shape(inner_air, pub), device)
        pg_vp = lift_program(paging_air, ppo2, len(ppub),
                             publics_shape(paging_air, ppub), device)
        nodes.append(join_program(seg_vp, pg_vp, device))
    for a_air, a_po2, a_pub in (accel or []):
        nodes.append(lift_program(a_air, a_po2, len(a_pub),
                                  publics_shape(a_air, a_pub), device))
    root_air = _fold_programs(nodes, device).air()
    verifier_mod.verify(root_air, receipt.proof,
                        [int(x) for x in receipt.claim], device=device)
