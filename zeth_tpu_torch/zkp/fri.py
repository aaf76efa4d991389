"""FRI low-degree proof: device commit/fold, host verify.

Counterpart of ``zeth_tpu.zkp.fri``, with the same parameters (blowup 4,
fold factor 16, 50 queries, final-degree cutoff 256, 20 grinding bits).
Each fold round is a batched 16-point iNTT over the group axis fused with
the per-position phi/x0 power scaling; each layer commit is one batched
Merkle build. The host verifier is a jax-free copy of the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from .. import field as F
from .. import hostmath as H
from .. import ntt
from ..hash import merkle
from ..hostmath import P
from .transcript import Transcript

FRI_FOLD = 16
BLOWUP = 4
QUERIES = 50
FRI_MIN_DEGREE = 256
POW_BITS = 20       # Fiat-Shamir grinding before query sampling


def _dev(a, device) -> torch.Tensor:
    """Standard-form host values -> Montgomery int32 tensor on `device`."""
    return torch.from_numpy(H.to_monty_np(a).view(np.int32)).to(device)


def group_matrix(evals):
    """(N, 4) ext evals -> (N/16, 64) rows; row g = positions {g + k*N/16}."""
    n = evals.shape[0]
    m = n // FRI_FOLD
    return evals.reshape(FRI_FOLD, m, 4).transpose(0, 1).reshape(m, FRI_FOLD * 4)


def fold16(evals, phi_monty, inv_x0_monty):
    """One FRI fold. evals: (N, 4) Montgomery; phi: (4,); inv_x0: (N/16,).

    f(x) = sum_j x^j g_j(x^16); output f'(y_g) = sum_j (phi/x0_g)^j u_j(g)
    where u = iNTT_16 over the within-group axis and x0_g = h*w_N^g.
    """
    n = evals.shape[0]
    m = n // FRI_FOLD
    u = ntt.intt(evals.reshape(FRI_FOLD, m, 4))            # (16, m, 4)
    s = F.ext_mul_base(phi_monty.expand(m, 4), inv_x0_monty)
    out, powj = u[0], s
    for j in range(1, FRI_FOLD):
        out = F.ext_add(out, F.ext_mul(u[j], powj))
        if j + 1 < FRI_FOLD:
            powj = F.ext_mul(powj, s)
    return out


@dataclass
class FriLayerOpening:
    row: np.ndarray     # (64,) standard-form base values of the group row
    path: np.ndarray    # (depth, 8) sibling digests


@dataclass
class FriProof:
    layer_roots: list       # list of (8,) digests
    final_coeffs: np.ndarray  # (d, 4) ext coefficients, standard form
    openings: list = dfield(default_factory=list)  # [query][layer] -> FriLayerOpening
    pow_nonce: int = 0      # grinding nonce (POW_BITS)


def _open_all_layers(layers, pos_per_layer):
    """Rows + sibling paths for all queries on all layers."""
    rows_per_layer, paths_per_layer = [], []
    for (tree, lay, _, _), gl in zip(layers, pos_per_layer):
        m = lay.shape[0] // FRI_FOLD
        idx = torch.as_tensor(np.asarray(gl, np.int64), device=lay.device)
        rows = lay.reshape(FRI_FOLD, m, 4).index_select(1, idx)
        rows = rows.transpose(0, 1).reshape(len(gl), FRI_FOLD * 4)
        rows_per_layer.append(H.from_monty_np(
            rows.cpu().numpy().view(np.uint32)))
        depth = len(tree.layers) - 1
        sibs = merkle._gather_paths(
            tree.layers, merkle._sibling_index_rows(gl, depth))
        paths_per_layer.append(
            [np.stack([sibs[d][qi] for d in range(depth)])
             if depth else np.zeros((0, 8), np.uint64)
             for qi in range(len(gl))])
    return rows_per_layer, paths_per_layer


def _inv_x0_table(shift: int, n: int) -> np.ndarray:
    """Standard-form table of (shift * w_n^g)^-1 for g < n/16."""
    m = n // FRI_FOLD
    s_inv = pow(int(shift), P - 2, P)
    return H.powers(H.rou_rev(n), m) * np.uint64(s_inv) % np.uint64(P)


def prove(evals, shift: int, degree: int, transcript: Transcript,
          mesh=None):
    """FRI commit + query phase.

    evals: (degree*BLOWUP, 4) Montgomery tensor -- evaluations of a
    degree-<`degree` ext polynomial on the coset shift*<w_N>.
    Returns (FriProof, query_indices); the caller must open its own trace
    commitments at the same query indices. With a mesh every rank runs
    the same FRI on the whole `evals`, and the ranks share the grind.
    """
    from .prover import _Stage
    n0 = evals.shape[0]
    assert n0 == degree * BLOWUP and n0 % FRI_FOLD == 0
    device = evals.device

    layers = []   # (tree, evals, domain_size, shift)
    cur, cur_shift, deg = evals, int(shift), int(degree)
    while deg > FRI_MIN_DEGREE:
        with _Stage(f"  fri commit deg=2^{deg.bit_length() - 1}"):
            tree = merkle.commit_rows(group_matrix(cur))
            transcript.mix(tree.root)
        phi = transcript.sample_ext()
        layers.append((tree, cur, cur.shape[0], cur_shift))
        with _Stage("  fri fold"):
            cur = fold16(cur, _dev(phi, device),
                         _dev(_inv_x0_table(cur_shift, cur.shape[0]), device))
        cur_shift = pow(cur_shift, FRI_FOLD, P)
        deg //= FRI_FOLD

    # Final polynomial: iNTT over the last domain, remove the coset shift.
    with _Stage("  fri final poly"):
        coeffs = H.from_monty_np(ntt.intt(cur).cpu().numpy().view(np.uint32))
        s_inv_pows = H.powers(pow(cur_shift, P - 2, P), coeffs.shape[0])
        coeffs = (coeffs * s_inv_pows[:, None]) % np.uint64(P)
        assert (coeffs[deg:] == 0).all(), \
            "final FRI polynomial exceeds degree bound"
        final_coeffs = coeffs[:deg].copy()
        transcript.mix_values(final_coeffs.reshape(-1))

    # PoW grinding, then queries
    with _Stage("  fri grind"):
        nonce = transcript.grind(POW_BITS, device, mesh)
    qs = [transcript.sample_index(n0) for _ in range(QUERIES)]
    proof = FriProof(
        layer_roots=[t.root for (t, _, _, _) in layers],
        final_coeffs=final_coeffs,
        pow_nonce=nonce,
    )
    pos_per_layer = []       # [layer][query] -> g
    cur_pos = list(qs)
    for (_, _, n_l, _) in layers:
        m = n_l // FRI_FOLD
        cur_pos = [p % m for p in cur_pos]
        pos_per_layer.append(list(cur_pos))
    with _Stage("  fri openings"):
        rows_per_layer, paths_per_layer = _open_all_layers(
            layers, pos_per_layer)
    for qi in range(len(qs)):
        proof.openings.append([
            FriLayerOpening(row=rows_per_layer[li][qi],
                            path=paths_per_layer[li][qi])
            for li in range(len(layers))])
    return proof, qs


# ---------------------------------------------------------------------------
# Host verification
# ---------------------------------------------------------------------------


def _intt16_np(vals_ext: np.ndarray) -> np.ndarray:
    """Host 16-point ext iNTT (vals: (16, 4) standard form)."""
    w_inv = H.rou_rev(FRI_FOLD)
    out = np.zeros((FRI_FOLD, 4), dtype=np.uint64)
    for j in range(FRI_FOLD):
        acc = np.zeros(4, dtype=np.uint64)
        wj = H.powers(pow(w_inv, j, P), FRI_FOLD)
        for k in range(FRI_FOLD):
            acc = H.ext_add(acc, (vals_ext[k].astype(np.uint64) * wj[k]) % H.PU)
        out[j] = (acc * np.uint64(pow(FRI_FOLD, P - 2, P))) % H.PU
    return out


def verify(proof: FriProof, degree: int, shift: int, transcript: Transcript,
           inner) -> list[int]:
    """Replay the FRI transcript and check all query chains.

    inner(q) -> (4,) standard-form ext value of the committed polynomial at
    domain index q (computed by the caller from its own trace openings).
    Returns the query indices. Raises ValueError on any failure.
    """
    n0 = degree * BLOWUP
    # replay commit phase
    phis = []
    domains = []
    deg, cur_shift, n_l = int(degree), int(shift), n0
    li = 0
    while deg > FRI_MIN_DEGREE:
        transcript.mix(proof.layer_roots[li])
        phis.append(transcript.sample_ext())
        domains.append((n_l, cur_shift))
        cur_shift = pow(cur_shift, FRI_FOLD, P)
        n_l //= FRI_FOLD
        deg //= FRI_FOLD
        li += 1
    if li != len(proof.layer_roots):
        raise ValueError("fri: layer count mismatch")
    if proof.final_coeffs.shape[0] != deg:
        raise ValueError("fri: final degree mismatch")
    if proof.final_coeffs.ndim != 2 or proof.final_coeffs.shape[1] != 4:
        raise ValueError("fri: final coeff shape")
    transcript.mix_values(np.asarray(proof.final_coeffs, np.uint64).reshape(-1))
    if not transcript.check_grind(POW_BITS, proof.pow_nonce):
        raise ValueError("fri: proof-of-work grinding check failed")
    qs = [transcript.sample_index(n0) for _ in range(QUERIES)]
    if len(proof.openings) != len(qs):
        raise ValueError("fri: opening count mismatch")

    # batched Merkle verification: all queries per layer at once
    for ell in range(len(domains)):
        n_l = domains[ell][0]
        m = n_l // FRI_FOLD
        gl, rows_l, paths_l = [], [], []
        for qi, q in enumerate(qs):
            if len(proof.openings[qi]) != len(domains):
                raise ValueError("fri: layer opening count mismatch")
            pos = q
            for e2 in range(ell):
                pos = pos % (domains[e2][0] // FRI_FOLD)
            gl.append(pos % m)
            rows_l.append(np.asarray(proof.openings[qi][ell].row))
            paths_l.append(proof.openings[qi][ell].path)
        if not merkle.verify_many(proof.layer_roots[ell], gl, rows_l,
                                  paths_l, depth=m.bit_length() - 1,
                                  width=FRI_FOLD * 4):
            raise ValueError(f"fri: bad merkle path (layer {ell})")

    for qi, q in enumerate(qs):
        pos = q
        value = np.asarray(inner(q), dtype=np.uint64)
        if len(proof.openings[qi]) != len(domains):
            raise ValueError("fri: layer opening count mismatch")
        for ell, ((n_l, h_l), phi) in enumerate(zip(domains, phis)):
            opening = proof.openings[qi][ell]
            m = n_l // FRI_FOLD
            g = pos % m
            k = pos // m
            vals = opening.row.reshape(FRI_FOLD, 4)
            if not (vals[k] == value).all():
                raise ValueError(f"fri: layer value mismatch (query {qi} layer {ell})")
            u = _intt16_np(vals)
            x0 = int(h_l) * pow(H.rou_fwd(n_l), g, P) % P
            s = H.ext_mul(phi, H.ext(pow(x0, P - 2, P)))
            acc = u[0]
            powj = s
            for j in range(1, FRI_FOLD):
                acc = H.ext_add(acc, H.ext_mul(u[j], powj))
                if j + 1 < FRI_FOLD:
                    powj = H.ext_mul(powj, s)
            value = acc
            pos = g
        # final polynomial evaluation at the remaining position
        n_fin, h_fin = (domains[-1][0] // FRI_FOLD,
                        pow(domains[-1][1], FRI_FOLD, P)) if domains else (n0, shift)
        x = int(h_fin) * pow(H.rou_fwd(n_fin), pos, P) % P
        xp = H.powers(x, proof.final_coeffs.shape[0])
        want = np.zeros(4, dtype=np.uint64)
        for j in range(proof.final_coeffs.shape[0]):
            want = H.ext_add(want, (proof.final_coeffs[j] * xp[j]) % H.PU)
        if not (want == value).all():
            raise ValueError(f"fri: final polynomial mismatch (query {qi})")
    return qs
