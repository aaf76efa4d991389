"""Verifier-program compiler: the full STARK verifier as a recursion-VM
program (the cryptographic core of lift/join).

Replaces the *programs* of risc0-circuit-recursion 4.0.2 (SURVEY.md §2.2:
"a small VM for verifying STARKs in-circuit" running lift/join/resolve).
The reference crate is unmounted; this compiler is an original design: it
walks the SAME host verifier logic (zkp/verifier.py + zkp/fri.py), but
emits recursion-VM rows instead of executing, reusing the AIR's captured
constraint tape (zkp/tape.py) so the DEEP-ALI check costs exactly one FMA
row per tape op.

A compiled program verifies one StarkProof of a fixed shape
(air, po2, n_publics):

  transcript replay (Poseidon2 duplex mirror)  -> all challenges
  tape replay over the DEEP taps               -> DEEP-ALI identity at z
  FRI: final-poly + grinding + per-query folds -> low-degree check
  Merkle: every group/layer opening            -> commitment binding
  claim: outer publics = H(po2 || H(inner publics))

The inner proof arrives as the witness *stream* (see proof_to_stream);
the program's control root — pinned by the outer verifier — fixes every
address/opcode, so a satisfied trace implies the host verifier would have
accepted the streamed proof with the claimed publics.

Port note: a jax-free copy of ``zeth_tpu.recursion.compiler``. It walks the
port's verifier, FRI and tape, and emits the same programs. The inner
control root is committed on `device` (None: the CUDA card) by the port's
verifier, where the reference defaults to its own device; the claim's
digest over the inner publics is one sponge row hashed by
``poseidon2.sponge_row`` on `device` (the same value as ``hash_rows_np``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import hostmath as H
from ..convert import resolve_device
from ..hash import poseidon2 as P2
from ..hostmath import GENERATOR, P
from ..zkp import fri
from ..zkp.prover import TAP_STREAMS, BLOWUP
from ..zkp.tape import OP_MUL as TAPE_MUL
from . import vm
from .builder import Builder, RTranscript


def _fri_layout(po2: int):
    """Replicates fri.prove's layer structure for degree n = 2^po2."""
    n = 1 << po2
    n0 = n * BLOWUP
    domains = []                       # (n_l, shift) per layer
    deg, shift, n_l = n, GENERATOR, n0
    while deg > fri.FRI_MIN_DEGREE:
        domains.append((n_l, shift))
        shift = pow(shift, fri.FRI_FOLD, P)
        n_l //= fri.FRI_FOLD
        deg //= fri.FRI_FOLD
    return domains, deg, (n0 if not domains else domains[-1][0] // fri.FRI_FOLD), \
        (GENERATOR if not domains else pow(domains[-1][1], fri.FRI_FOLD, P))


@dataclass
class VerifierProgram:
    """A compiled in-circuit verifier for proofs of one fixed shape."""
    program: vm.Program
    air_name: str
    po2: int                 # inner trace po2
    n_publics: int
    group_widths: dict       # group -> column count
    n_taps: int
    layer_domains: list      # [(n_l, shift)]
    final_degree: int
    depth: int               # group-tree path depth = po2 + 2

    def air(self) -> vm.RecursionAir:
        return vm.RecursionAir(self.program)


def _pow2_bits(n: int) -> int:
    b = n.bit_length() - 1
    assert 1 << b == n
    return b


def expected_control_root(inner_air, po2: int, device=None) -> np.ndarray:
    """The inner AIR's control-commitment root, committed on `device`
    (None: the CUDA card) by the verifier's cache, as the prover commits
    it."""
    from ..zkp import verifier as verifier_mod
    device = resolve_device(device)
    verifier_mod._AIR_REGISTRY[inner_air.name] = inner_air
    return np.array(verifier_mod._expected_control_root(inner_air.name, po2,
                                                        device),
                    dtype=np.uint64)


def compile_verifier(inner_air, po2: int, n_publics: int,
                     control_root=None, pub_shape=None,
                     device=None) -> VerifierProgram:
    """Build the verifier program for proofs of (inner_air, po2, n_publics).

    control_root: the inner AIR's expected control root, standard form
    (8,). If None it is committed on `device` (None: the CUDA card)
    through the verifier's cache. pub_shape: extra shape token for AIRs
    whose publics encode variable-length lists (passed to the
    derived-challenge hook, which must assert the in-proof counts match
    it).
    """
    b = Builder()
    pub_cells, extra_cells = emit_verify(b, inner_air, po2, n_publics,
                                         control_root,
                                         pub_shape=pub_shape,
                                         with_extra=True, device=device)
    # claim: outer publics = H(po2 || H(inner publics) || extra row).
    # For AIRs with companion bindings (rv32im: paging root, d0/d1 and
    # the sampled g4/g5) the extra row makes the claim pin them, so the
    # receipt-level resolve can check them against the paging publics.
    pub_digest = b.sponge_hash(pub_cells)
    claim = b.sponge_hash([b.const(po2)] + pub_digest + extra_cells)
    for j in range(8):
        b.bind_public(claim[j], j)
    sizes = {"control": inner_air.control_cols, "main": inner_air.main_cols,
             "aux": inner_air.aux_cols, "check": 16}
    domains, deg_fin, _, _ = _fri_layout(po2)
    return VerifierProgram(
        program=b.build(), air_name=inner_air.name, po2=po2,
        n_publics=n_publics, group_widths=sizes,
        n_taps=2 * (sizes["control"] + sizes["main"] + sizes["aux"]) + 16,
        layer_domains=domains, final_degree=deg_fin, depth=po2 + 2)


def emit_verify(b: Builder, inner_air, po2: int, n_publics: int,
                control_root=None, pub_shape=None, with_extra=False,
                device=None):
    """Emit a full STARK verification into builder b; returns the inner
    publics cells (stream inputs, for the caller's claim binding).

    with_extra=True additionally returns the companion-binding cells
    (for uses_extra_mix AIRs: the companion proof's main root, the d0/d1
    derived-scalar components, and the sampled g4/g5 components; empty
    list otherwise). device: where the control root is committed when
    control_root is None (None: the CUDA card)."""
    if control_root is None:
        control_root = expected_control_root(inner_air, po2, device)
    control_root = [int(x) for x in np.asarray(control_root).reshape(8)]

    sizes = {"control": inner_air.control_cols, "main": inner_air.main_cols,
             "aux": inner_air.aux_cols, "check": 16}
    tap_slices, off = {}, 0
    for (g, o) in TAP_STREAMS:
        tap_slices[(g, o)] = slice(off, off + sizes[g])
        off += sizes[g]
    n_taps = off
    n = 1 << po2
    n_z = sizes["control"] + sizes["main"] + sizes["aux"] + 16
    n_zg = sizes["control"] + sizes["main"] + sizes["aux"]
    depth = po2 + 2
    domains, deg_fin, n_fin, h_fin = _fri_layout(po2)

    from ..zkp.prover import _tape_program, register_air, scalar_publics
    register_air(inner_air)
    n_scalar_pub = len(scalar_publics(inner_air, list(range(n_publics))))
    tp = _tape_program(inner_air.name, n_scalar_pub)

    rt = RTranscript(b)

    # --- publics + roots into the transcript ------------------------------
    pub_cells = b.inputs(n_publics)
    rt.mix_values([b.const(po2)] + pub_cells)
    ctl_root = [b.const(v) for v in control_root]
    rt.mix_digest(ctl_root)
    main_root = b.inputs(8)
    rt.mix_digest(main_root)
    uses_extra = getattr(inner_air, "uses_extra_mix", False)
    extra_root = []
    if uses_extra:
        # companion-proof main root, mixed before challenge sampling
        # (mirrors prover.prove extra_mix)
        extra_root = b.inputs(8)
        rt.mix_digest(extra_root)
    bind_main = getattr(inner_air, "bind_claim_main_root", False)

    # sampled challenges (components kept for the tape's scalar slots)
    chal_comps, chal_ext = [], []
    for _ in range(inner_air.n_challenges):
        comps, e = rt.sample_ext_comps()
        chal_comps.append(comps)
        chal_ext.append(e)

    # derived challenge scalars (AIR hook; componentized for the tape)
    n_derived = getattr(inner_air, "n_derived", 0)
    extra_claim_cells = []
    if n_derived:
        rec_kwargs = {}
        if uses_extra:
            d0_comps = b.inputs(4)
            d1_comps = b.inputs(4)
            extra_cells = {"d0": b.combine_ext(d0_comps),
                           "d1": b.combine_ext(d1_comps)}
            rec_kwargs["extra_cells"] = extra_cells
            # claim binds: companion root, d0/d1, the sampled g4/g5
            extra_claim_cells = (list(extra_root) + list(d0_comps)
                                 + list(d1_comps) + list(chal_comps[4])
                                 + list(chal_comps[5]))
        derived = inner_air.derived_challenges_rec(b, pub_cells, chal_ext,
                                                   pub_shape, **rec_kwargs)
        assert len(derived) == n_derived
        for d in derived:
            chal_comps.append(b.ext_components(d))
            chal_ext.append(d)
    if bind_main:
        # the claim additionally pins this proof's own main root (the
        # value a companion claim's extra-mix binding refers to)
        extra_claim_cells = list(main_root) + extra_claim_cells

    aux_root = None
    if sizes["aux"]:
        aux_root = b.inputs(8)
        rt.mix_digest(aux_root)
    alpha = rt.sample_ext()
    check_root = b.inputs(8)
    rt.mix_digest(check_root)
    z = rt.sample_ext()

    # --- taps --------------------------------------------------------------
    tap_comp_cells = []            # flat: n_taps * 4 base cells
    for _ in range(n_taps):
        tap_comp_cells.extend(b.inputs(4))
    rt.mix_values(tap_comp_cells)
    tap_ext = [b.combine_ext(tap_comp_cells[4 * j:4 * j + 4])
               for j in range(n_taps)]

    # --- DEEP-ALI identity at z (tape replay) ------------------------------
    # scalar slots
    S: list[int] = []
    for rec in tp.scalar_prog:
        tag = rec[0]
        if tag == "const":
            S.append(b.const(rec[1] % P))
        elif tag == "pub":
            S.append(pub_cells[rec[1]])
        elif tag == "chal":
            S.append(chal_comps[rec[1]][rec[2]])
        elif tag == "add":
            S.append(b.add(S[rec[1]], S[rec[2]]))
        elif tag == "sub":
            S.append(b.sub(S[rec[1]], S[rec[2]]))
        elif tag == "mul":
            S.append(b.mul(S[rec[1]], S[rec[2]]))
        else:
            raise AssertionError(rec)

    # leaf cells: tap values (leaf 0 is the constant one)
    leaf_cells = []
    for (g, col, o) in tp.leaves:
        if g == "__one__":
            leaf_cells.append(b.ONE)
        else:
            leaf_cells.append(tap_ext[tap_slices[(g, o)].start + col])

    # replay tape ops; bmap: B-index -> cell
    bmap = {}
    for i, c in enumerate(leaf_cells):
        bmap[tp.n_regs + tp.n_stage + i] = c
    for op in tp.ops:
        opc, ai, bi, sa, sb, dst = (int(x) for x in op)
        if opc == TAPE_MUL:
            out = b.mul(bmap[ai], bmap[bi])
        else:
            out = b.fma(a=S[sa], b=bmap[ai], c=S[sb], d=bmap[bi],
                        s0=1, s1=1)
        bmap[dst] = out
    stage_cells = [bmap[tp.n_regs + e] for e in range(tp.n_stage)]

    # c_at_z = sum_i alpha^i * C_i  (Horner, descending)
    c_at_z = stage_cells[-1]
    for cst in reversed(stage_cells[:-1]):
        c_at_z = b.fma(a=c_at_z, b=alpha, c=cst, d=b.ONE, s0=1, s1=1)

    # z^n by squaring; z^(kn) Horner over check taps with basis recombine
    z_n = z
    for _ in range(po2):
        z_n = b.mul(z_n, z_n)
    check_taps = tap_ext[tap_slices[("check", 0)].start:
                         tap_slices[("check", 0)].stop]
    e1, e2, e3 = b._ext_basis()

    def basis_part(k):
        t = b.fma(a=check_taps[4 * k + 1], b=e1,
                  c=check_taps[4 * k + 2], d=e2, s0=1, s1=1)
        return b.fma(a=check_taps[4 * k + 3], b=e3,
                     c=check_taps[4 * k], d=b.ONE, e=t, s0=1, s1=1, s2=1)

    q_claim = basis_part(BLOWUP - 1)
    for k in range(BLOWUP - 2, -1, -1):
        q_claim = b.fma(a=q_claim, b=z_n, c=basis_part(k), d=b.ONE,
                        s0=1, s1=1)
    # check c_at_z == q_claim * (z^n - 1)  (avoids an inverse)
    zn1 = b.fma(a=z_n, b=b.ONE, s0=1, imm=P - 1)
    b.assert_cells_eq(c_at_z, b.mul(q_claim, zn1))

    # --- DEEP combination constants ----------------------------------------
    beta = rt.sample_ext()
    w_n = H.rou_fwd(n)
    # zg = z * w_n (base scalar)
    zg = b.scale(z, w_n)
    # beta^(n_z) by square-and-multiply (compile-time exponent)
    beta_nz = b.ONE
    for bit in bin(n_z)[2:]:
        beta_nz = b.mul(beta_nz, beta_nz)
        if bit == "1":
            beta_nz = b.mul(beta_nz, beta)

    # --- FRI commit-phase replay ------------------------------------------
    layer_roots, phis = [], []
    for _ in domains:
        r8 = b.inputs(8)
        rt.mix_digest(r8)
        layer_roots.append(r8)
        phis.append(rt.sample_ext())
    final_comp_cells = []
    for _ in range(deg_fin):
        final_comp_cells.extend(b.inputs(4))
    rt.mix_values(final_comp_cells)
    final_ext = [b.combine_ext(final_comp_cells[4 * j:4 * j + 4])
                 for j in range(deg_fin)]
    nonce = b.input()
    rt.check_grind(fri.POW_BITS, nonce)

    # --- queries -----------------------------------------------------------
    group_list = [g for g in ("control", "main", "aux", "check")
                  if sizes[g] > 0]
    roots_of = {"control": ctl_root, "main": main_root,
                "aux": aux_root, "check": check_root}

    def merkle_check(row_cells, bits, root_cells, tree_depth, sibs=None):
        digest = b.sponge_hash(row_cells)
        for d in range(tree_depth):
            sib = b.inputs(8) if sibs is None else sibs[d]
            digest = b.pair_hash_sel(bits[d], digest, sib)
        for j in range(8):
            b.assert_cells_eq(digest[j], root_cells[j])

    for _ in range(fri.QUERIES):
        q_bits = rt.sample_index_bits(4 * n)      # depth bits, LSB first

        # group openings (row + path cells in stream order: the DEEP
        # value is computed from the rows before the paths are checked)
        opened, sib_cells = {}, {}
        for g in group_list:
            opened[g] = b.inputs(sizes[g])
            sib_cells[g] = [b.inputs(8) for _ in range(depth)]
        # x = GENERATOR * w_{4n}^q
        x = b.scale(b.pow_from_bits(H.rou_fwd(BLOWUP * n), q_bits),
                    GENERATOR)
        inv_z = b.inv(b.sub(x, z))
        inv_zg = b.inv(b.sub(x, zg))

        def horner_over(groups, base_tap):
            cols = []                 # (row cell, tap cell) in ascending j
            j = base_tap
            for g in groups:
                for c in range(sizes[g]):
                    cols.append((opened[g][c], tap_ext[j]))
                    j += 1
            fx, vj = cols[-1]
            acc = b.fma(a=fx, b=b.ONE, c=vj, d=b.ONE, s0=1, s1=P - 1)
            for fx, vj in reversed(cols[:-1]):
                acc = b.fma(a=acc, b=beta, c=fx, d=b.ONE, e=vj,
                            s0=1, s1=1, s2=P - 1)
            return acc

        num_z = horner_over([g for g in ("control", "main", "aux", "check")
                             if sizes[g] > 0], 0)
        num_zg = horner_over([g for g in ("control", "main", "aux")
                              if sizes[g] > 0], n_z)
        t2 = b.mul(num_zg, inv_zg)
        value = b.fma(a=num_z, b=inv_z, c=t2, d=beta_nz, s0=1, s1=1)

        # group Merkle paths (shared q_bits)
        for g in group_list:
            merkle_check(opened[g], q_bits, roots_of[g], depth,
                         sibs=sib_cells[g])

        # FRI fold chain
        pos_bits = q_bits
        for ell, ((n_l, h_l), phi, r8) in enumerate(
                zip(domains, phis, layer_roots)):
            m_bits = _pow2_bits(n_l) - 4
            g_bits = pos_bits[:m_bits]
            k_bits = pos_bits[m_bits:m_bits + 4]
            row = b.inputs(fri.FRI_FOLD * 4)
            merkle_check(row, g_bits, r8, m_bits)
            vals = [b.combine_ext(row[4 * k:4 * k + 4])
                    for k in range(fri.FRI_FOLD)]
            # select vals[k] via the 4 k-bits (LSB-first mux tree)
            sel = vals
            for kb in k_bits:
                sel = [b.select(kb, sel[2 * i + 1], sel[2 * i])
                       for i in range(len(sel) // 2)]
            b.assert_cells_eq(sel[0], value)
            # u = iNTT_16(vals); fold = sum_j u_j s^j,  s = phi / x0
            w_inv = H.rou_rev(fri.FRI_FOLD)
            inv16 = pow(fri.FRI_FOLD, P - 2, P)
            u = []
            for j in range(fri.FRI_FOLD):
                coeffs = [pow(w_inv, j * k, P) * inv16 % P
                          for k in range(fri.FRI_FOLD)]
                u.append(b.dot_const(coeffs, vals))
            x0_inv = b.pow_from_bits(H.rou_rev(n_l), g_bits)
            s = b.fma(a=phi, b=x0_inv, s0=pow(int(h_l), P - 2, P))
            acc = u[-1]
            for uj in reversed(u[:-1]):
                acc = b.fma(a=acc, b=s, c=uj, d=b.ONE, s0=1, s1=1)
            value = acc
            pos_bits = g_bits

        # final polynomial evaluation
        xf = b.scale(b.pow_from_bits(H.rou_fwd(n_fin), pos_bits), h_fin)
        acc = final_ext[-1]
        for cj in reversed(final_ext[:-1]):
            acc = b.fma(a=acc, b=xf, c=cj, d=b.ONE, s0=1, s1=1)
        b.assert_cells_eq(acc, value)

    if with_extra:
        return pub_cells, extra_claim_cells
    return pub_cells


# ---------------------------------------------------------------------------
# Stream serialization (must consume in exactly the program's input order)
# ---------------------------------------------------------------------------


def proof_to_stream(vp: VerifierProgram, proof, extra=None) -> np.ndarray:
    """Serialize a StarkProof into the witness stream for vp's program.

    extra: for uses_extra_mix inner AIRs, the companion bindings
    (companion_main_root(8,), d0(4,), d1(4,)) consumed by the program
    right where emit_verify read them."""
    out: list[int] = []

    def put(vals):
        out.extend(int(v) % P for v in np.asarray(vals).reshape(-1))

    put(proof.publics)
    put(proof.roots["main"])
    if extra is not None:
        put(extra[0])             # companion main root (mixed)
        put(extra[1])             # d0 components
        put(extra[2])             # d1 components
    if vp.group_widths["aux"]:
        put(proof.roots["aux"])
    put(proof.roots["check"])
    put(proof.taps)                       # (n_taps, 4) row-major
    fp = proof.fri_proof
    for r in fp.layer_roots:
        put(r)
    put(fp.final_coeffs)
    put([fp.pow_nonce])
    group_list = [g for g in ("control", "main", "aux", "check")
                  if vp.group_widths[g] > 0]
    for qi in range(fri.QUERIES):
        for g in group_list:
            put(proof.openings[g].rows[qi])
            put(proof.openings[g].paths[qi])       # (depth, 8)
        for ell in range(len(vp.layer_domains)):
            op = fp.openings[qi][ell]
            put(op.row)
            put(op.path)
    # callers check total length against their program's n_stream (a join
    # program consumes the concatenation of two of these streams)
    return np.array(out, dtype=np.uint64)


def claim_digest(po2: int, publics, extra_row=None,
                 device=None) -> np.ndarray:
    """Host mirror of the program's outer claim:
    H(po2 || H(publics) || extra_row).

    extra_row: for uses_extra_mix AIRs, the 24 companion-binding values
    [companion_root(8), d0(4), d1(4), g4(4), g5(4)]. H(publics) is one
    sponge row of up to millions of values: ``sponge_row`` hashes it on
    `device` (None: the CUDA card), equal to ``hash_rows_np``."""
    pubs = np.asarray([int(p) % P for p in publics], dtype=np.uint64)
    pd = (P2.sponge_row(pubs, resolve_device(device)) if pubs.size
          else P2.hash_rows_np(pubs[None])[0])
    parts = [np.array([po2], np.uint64), pd]
    if extra_row is not None:
        parts.append(np.asarray(extra_row, np.uint64).reshape(-1))
    return P2.hash_rows_np(np.concatenate(parts)[None])[0]
