"""Symbolic constraint capture + device tape evaluator.

Counterpart of ``zeth_tpu.zkp.tape``. ``air.constraints()`` runs ONCE on
the host with symbolic ops, producing a hash-consed DAG; the DAG is
lowered to a linear tape of two fat vector ops (LINC: ``s_a*A + s_b*B``;
MUL: ``A*B``) and re-scheduled by level. The host half (``Capture``,
``SymOps``, ``capture``, ``lower``, ``eval_scalars``, ``build_levels``) is
a jax-free copy of the reference; the device half evaluates the level
program over blocks of LDE rows with torch (``eval_check``) and folds the
alpha-mix of every constraint. On a mesh each rank evaluates its own LDE
row block, extended by a halo of the next rank's first rows
(``eval_check(halo=...)``). The reference's scan interpreter
(``_build_leafmat``, ``_build_leafblock``, ``_run_block``) is ported as
the op-by-op ``run_block`` (``eval_check(single_block=True)``), a second
evaluator the tests hold against the level schedule.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import field as F
from .. import hostmath as H
from ..hostmath import P

# node kinds
K_CONST, K_SCALAR, K_LEAF, K_ADD, K_SUB, K_MUL = range(6)
# tape opcodes
OP_LINC, OP_MUL = 0, 1

BLOCK_ROWS = 1 << 17          # LDE rows per interpreter block
# a block's level buffer (n_rows x block rows, int32) holds about this many
# elements; its int64 temporaries are a level's rows x block rows
BLOCK_ELEMS = 1 << 28
STRIDE = 4                    # LDE rows per trace row (blowup 4)


class _Node:
    __slots__ = ("i", "kind", "a", "b", "payload", "deg", "is_scalar")

    def __init__(self, i, kind, a, b, payload, deg, is_scalar):
        self.i = i
        self.kind = kind
        self.a = a
        self.b = b
        self.payload = payload
        self.deg = deg
        self.is_scalar = is_scalar


class Capture:
    """Builds the hash-consed DAG while air.constraints() runs."""

    def __init__(self):
        self.nodes: list[_Node] = []
        self._memo: dict = {}

    def _intern(self, kind, a, b, payload, deg, is_scalar):
        if kind in (K_ADD, K_MUL):          # commutative canonical order
            ka, kb = (a.i, b.i) if a.i <= b.i else (b.i, a.i)
            if ka != a.i:
                a, b = b, a
        key = (kind, a.i if a else -1, b.i if b else -1, payload)
        n = self._memo.get(key)
        if n is None:
            n = _Node(len(self.nodes), kind, a, b, payload, deg, is_scalar)
            self.nodes.append(n)
            self._memo[key] = n
        return n

    def const(self, c: int):
        return self._intern(K_CONST, None, None, int(c) % P, 0, True)

    def scalar(self, tag):
        """Runtime scalar input: ('pub', i) or ('chal', i, comp)."""
        return self._intern(K_SCALAR, None, None, tag, 0, True)

    def leaf(self, group: str, col: int, offset: int):
        return self._intern(K_LEAF, None, None, (group, col, offset), 1, False)

    def add(self, a, b):
        if a.kind == K_CONST and b.kind == K_CONST:
            return self.const(a.payload + b.payload)
        if a.kind == K_CONST and a.payload == 0:
            return b
        if b.kind == K_CONST and b.payload == 0:
            return a
        return self._intern(K_ADD, a, b, None, max(a.deg, b.deg),
                            a.is_scalar and b.is_scalar)

    def sub(self, a, b):
        if a.kind == K_CONST and b.kind == K_CONST:
            return self.const(a.payload - b.payload)
        if b.kind == K_CONST and b.payload == 0:
            return a
        if a is b:
            return self.const(0)
        return self._intern(K_SUB, a, b, None, max(a.deg, b.deg),
                            a.is_scalar and b.is_scalar)

    def mul(self, a, b):
        if a.kind == K_CONST and b.kind == K_CONST:
            return self.const(a.payload * b.payload)
        for x, y in ((a, b), (b, a)):
            if x.kind == K_CONST:
                if x.payload == 0:
                    return self.const(0)
                if x.payload == 1:
                    return y
        return self._intern(K_MUL, a, b, None, a.deg + b.deg,
                            a.is_scalar and b.is_scalar)

    def neg(self, a):
        return self.sub(self.const(0), a)


class SymOps:
    """ops-object passed to air.constraints() during capture."""

    is_device = False

    def __init__(self, cap: Capture):
        self._cap = cap
        self.add = cap.add
        self.sub = cap.sub
        self.mul = cap.mul
        self.neg = cap.neg
        self.const = cap.const


@dataclass
class TapeProgram:
    ops: np.ndarray            # (T, 6) int32 [opcode, a, b, sa, sb, dst]
    n_regs: int
    n_stage: int               # number of constraints (stage rows)
    leaves: list               # [(group, col, offset)] — leaf i at B[n_regs+n_stage+i]
    scalar_prog: list          # per-S-slot recipe (see _eval_scalars)
    max_degree: int


def _to_monty_np(a) -> np.ndarray:
    return H.to_monty_np(a)


def capture(air, n_publics: int, challenges_sym) -> TapeProgram:
    """Run air.constraints symbolically and lower the DAG to a tape.

    challenges_sym: list passed as the ``challenges`` argument (built by
    the caller from cap.scalar tags — single scalars or 4-tuples).
    """
    cap = Capture()
    ops_obj = SymOps(cap)
    publics = [cap.scalar(("pub", i)) for i in range(n_publics)]
    chals = challenges_sym(cap)

    def v(group, col, offset=0):
        return cap.leaf(group, int(col), int(offset))

    roots = air.constraints(v, ops_obj, publics, chals)
    return lower(cap, roots)


def lower(cap: Capture, roots: list) -> TapeProgram:
    """DAG -> (scalar program, leaf list, register-allocated tape)."""
    nodes = cap.nodes
    n_nodes = len(nodes)

    # liveness: which nodes are actually needed
    needed = np.zeros(n_nodes, dtype=bool)
    stack = [r.i for r in roots]
    while stack:
        i = stack.pop()
        if needed[i]:
            continue
        needed[i] = True
        nd = nodes[i]
        if nd.a is not None:
            stack.append(nd.a.i)
        if nd.b is not None:
            stack.append(nd.b.i)

    # scalar slots: S[0]=1, S[1]=0, then one slot per needed scalar node
    scalar_prog = [("const", 1), ("const", 0)]
    scalar_slot = {}

    def slot_of(nd) -> int:
        s = scalar_slot.get(nd.i)
        if s is not None:
            return s
        if nd.kind == K_CONST:
            if nd.payload == 1:
                s = 0
            elif nd.payload == 0:
                s = 1
            else:
                s = len(scalar_prog)
                scalar_prog.append(("const", nd.payload))
        elif nd.kind == K_SCALAR:
            s = len(scalar_prog)
            scalar_prog.append(nd.payload)
        else:   # derived scalar node
            opn = {K_ADD: "add", K_SUB: "sub", K_MUL: "mul"}[nd.kind]
            sa, sb = slot_of(nd.a), slot_of(nd.b)
            s = len(scalar_prog)
            scalar_prog.append((opn, sa, sb))
        scalar_slot[nd.i] = s
        return s

    # leaf slots
    leaves = [("__one__", 0, 0)]
    leaf_idx = {}

    # last use index (over row-valued nodes, in node order = topo order)
    last_use = np.full(n_nodes, -1, dtype=np.int64)
    for nd in nodes:
        if not needed[nd.i] or nd.is_scalar:
            continue
        for op in (nd.a, nd.b):
            if op is not None and not op.is_scalar:
                last_use[op.i] = nd.i
    n_stage = len(roots)
    for r in roots:
        last_use[r.i] = n_nodes + 1     # roots live to the end

    # register allocation + tape emission
    loc: dict[int, tuple] = {}          # node -> ("reg"|"stage"|"leaf", idx)
    free_regs: list[int] = []
    n_regs = 0
    tape = []                            # rows appended as python lists
    root_stage = {}
    for e, r in enumerate(roots):
        root_stage.setdefault(r.i, []).append(e)

    # map locations to B-row indices later (need final n_regs first)
    def alloc_reg():
        nonlocal n_regs
        if free_regs:
            return free_regs.pop()
        n_regs += 1
        return n_regs - 1

    pending_release: dict[int, list[int]] = {}

    def operand(nd):
        """Return ('row', loc) or ('scalar', slot)."""
        if nd.is_scalar:
            return ("scalar", slot_of(nd))
        return ("row", loc[nd.i])

    max_deg = 0
    for nd in nodes:
        if not needed[nd.i] or nd.is_scalar:
            continue
        max_deg = max(max_deg, nd.deg)
        if nd.kind == K_LEAF:
            li = leaf_idx.get(nd.payload)
            if li is None:
                li = len(leaves)
                leaves.append(nd.payload)
                leaf_idx[nd.payload] = li
            loc[nd.i] = ("leaf", li)
        else:
            a, b = nd.a, nd.b
            oa, ob = operand(a), operand(b)
            # destination: a stage row if this node is a constraint root,
            # else a temp register
            stages = root_stage.get(nd.i, [])
            if stages:
                dst = ("stage", stages[0])
            else:
                dst = ("reg", alloc_reg())
            if nd.kind == K_MUL and oa[0] == "row" and ob[0] == "row":
                tape.append([OP_MUL, oa[1], ob[1], 0, 0, dst])
            else:
                # express as LINC: s_a*A + s_b*B
                if nd.kind == K_MUL:
                    # one operand is scalar
                    (srow, sslot) = (oa, ob) if oa[0] == "row" else (ob, oa)
                    tape.append([OP_LINC, srow[1], srow[1],
                                 sslot[1], 1, dst])     # s*A + 0*A
                elif nd.kind in (K_ADD, K_SUB):
                    neg1 = _scalar_const(scalar_prog, scalar_slot, P - 1)
                    if oa[0] == "row" and ob[0] == "row":
                        sb = 0 if nd.kind == K_ADD else neg1
                        tape.append([OP_LINC, oa[1], ob[1], 0, sb, dst])
                    elif oa[0] == "row":            # row op scalar
                        sb = ob[1] if nd.kind == K_ADD else _scalar_negate(
                            scalar_prog, scalar_slot, ob[1])
                        tape.append([OP_LINC, oa[1], ("leaf", 0), 0, sb, dst])
                    else:                            # scalar op row
                        sa = oa[1]
                        sb = 0 if nd.kind == K_ADD else neg1
                        tape.append([OP_LINC, ("leaf", 0), ob[1], sa, sb, dst])
                else:
                    raise AssertionError(nd.kind)
            loc[nd.i] = dst
            # extra stage copies for duplicate roots
            for e in stages[1:]:
                tape.append([OP_LINC, dst, dst, 0, 1, ("stage", e)])
            # release dead operands
            for opn in (a, b):
                if (opn is not None and not opn.is_scalar
                        and last_use[opn.i] == nd.i):
                    l = loc.get(opn.i)
                    if l and l[0] == "reg":
                        free_regs.append(l[1])
                        loc.pop(opn.i)

    # roots that are leaves or scalars need explicit stage materialization
    for e, r in enumerate(roots):
        if r.is_scalar:
            tape.append([OP_LINC, ("leaf", 0), ("leaf", 0),
                         slot_of(r), 1, ("stage", e)])
        elif r.kind == K_LEAF:
            tape.append([OP_LINC, loc[r.i], loc[r.i], 0, 1, ("stage", e)])

    # resolve locations to flat B indices: [regs | stage | leaves]
    def b_index(l):
        kind, idx = l
        if kind == "reg":
            return idx
        if kind == "stage":
            return n_regs + idx
        return n_regs + n_stage + idx

    ops_arr = np.zeros((len(tape), 6), dtype=np.int32)
    for t, (opc, a, b, sa, sb, dst) in enumerate(tape):
        ops_arr[t] = [opc, b_index(a) if isinstance(a, tuple) else a,
                      b_index(b) if isinstance(b, tuple) else b,
                      sa, sb, b_index(dst)]
    # fix: 'reg' operands recorded as raw ints inside tuples only; normalize
    return TapeProgram(ops=ops_arr, n_regs=n_regs, n_stage=n_stage,
                       leaves=leaves, scalar_prog=scalar_prog,
                       max_degree=max_deg)


def _scalar_const(scalar_prog, scalar_slot, v):
    key = ("rawconst", v)
    s = scalar_slot.get(key)
    if s is None:
        s = len(scalar_prog)
        scalar_prog.append(("const", v))
        scalar_slot[key] = s
    return s


def _scalar_negate(scalar_prog, scalar_slot, slot):
    key = ("neg", slot)
    s = scalar_slot.get(key)
    if s is None:
        s = len(scalar_prog)
        scalar_prog.append(("sub", 1, slot))    # 0 - x  (S[1] = 0)
        scalar_slot[key] = s
    return s


def eval_scalars(tp: TapeProgram, publics, challenges) -> np.ndarray:
    """Compute the runtime scalar array S (Montgomery uint32).

    challenges: (n_challenges, 4) standard-form numpy.
    """
    vals = np.zeros(len(tp.scalar_prog), dtype=np.uint64)
    for i, rec in enumerate(tp.scalar_prog):
        tag = rec[0]
        if tag == "const":
            vals[i] = rec[1] % P
        elif tag == "pub":
            vals[i] = int(publics[rec[1]]) % P
        elif tag == "chal":
            vals[i] = int(challenges[rec[1]][rec[2]]) % P
        elif tag == "add":
            vals[i] = (vals[rec[1]] + vals[rec[2]]) % P
        elif tag == "sub":
            vals[i] = (vals[rec[1]] + P - vals[rec[2]]) % P
        elif tag == "mul":
            vals[i] = vals[rec[1]] * vals[rec[2]] % P
        else:
            raise AssertionError(rec)
    return _to_monty_np(vals)


# ---------------------------------------------------------------------------
# Level-parallel device evaluation
# ---------------------------------------------------------------------------
#
# The constraint DAG is only a few dozen levels deep with wide levels, so
# the tape reorders into a *level schedule*: every level is two batched
# gathers + one elementwise op + one contiguous row-block write.


@dataclass
class LevelProgram:
    n_rows: int          # leaf rows + one row per op (SSA, level-major)
    n_leaves: int
    levels: tuple        # (row_off, m_ia, m_ib, l_ia, l_ib, l_sa, l_sb)
    stage_rows: np.ndarray          # (n_stage,) final row id per constraint
    leaf_groups: tuple   # ((group, off, col_idx_tuple), ...) in leaf order
    has_one: bool        # leaf row 0 is the constant-one row


def build_levels(tp: TapeProgram) -> LevelProgram:
    """Re-schedule a TapeProgram into the level-parallel SSA layout.

    Leaves are permuted so each (group, offset) stream is contiguous
    (leaf assembly becomes per-group slice+take, not per-leaf stacking);
    op rows are assigned level-major so each level writes one contiguous
    row block.
    """
    n_regs, n_stage = tp.n_regs, tp.n_stage
    n_leaves = len(tp.leaves)
    base = n_regs + n_stage

    # group leaves by (group, offset); leaf 0 is ('__one__', 0, 0)
    from collections import defaultdict
    grouped = defaultdict(list)
    has_one = tp.leaves[0][0] == "__one__"
    for i, (g, c, off) in enumerate(tp.leaves):
        if g == "__one__":
            continue
        grouped[(g, off)].append((i, c))
    leaf_perm = np.zeros(n_leaves, dtype=np.int64)   # old leaf idx -> new row
    leaf_groups = []
    pos = 1 if has_one else 0
    if has_one:
        leaf_perm[0] = 0
    for (g, off), items in sorted(grouped.items()):
        cols = []
        for i, c in items:
            leaf_perm[i] = pos
            pos += 1
            cols.append(c)
        leaf_groups.append((g, off, tuple(cols)))
    assert pos == n_leaves

    # SSA rename over the tape (B-slot space: [regs | stage | leaves])
    cur = {base + i: int(leaf_perm[i]) for i in range(n_leaves)}
    depth = [0] * n_leaves
    recs = []                        # [lev, opc, ia, ib, sa, sb, ssa_id]
    stage_src = [None] * n_stage
    for opc, a, b, sa, sb, dst in tp.ops.tolist():
        ia, ib = cur[a], cur[b]
        lev = max(depth[ia], depth[ib]) + 1
        rid = n_leaves + len(recs)
        depth.append(lev)
        recs.append([lev, opc, ia, ib, sa, sb, rid])
        cur[dst] = rid
        if n_regs <= dst < base:
            stage_src[dst - n_regs] = rid
    assert all(s is not None for s in stage_src), "unwritten stage row"

    # level-major final row ids (muls first within a level)
    by_level = defaultdict(list)
    for r in recs:
        by_level[r[0]].append(r)
    remap = {i: i for i in range(n_leaves)}
    levels = []
    row_off = n_leaves
    for lev in sorted(by_level):
        rs = by_level[lev]
        muls = [r for r in rs if r[1] == OP_MUL]
        lincs = [r for r in rs if r[1] == OP_LINC]
        start = row_off
        for r in muls + lincs:
            remap[r[6]] = row_off
            row_off += 1
        arr = lambda rows, j: np.array([remap[r[j]] for r in rows], np.int32)
        levels.append((
            start,
            arr(muls, 2), arr(muls, 3),
            arr(lincs, 2), arr(lincs, 3),
            np.array([r[4] for r in lincs], np.int32),
            np.array([r[5] for r in lincs], np.int32),
        ))
    stage_rows = np.array([remap[s] for s in stage_src], np.int32)
    return LevelProgram(n_rows=row_off, n_leaves=n_leaves,
                        levels=tuple(levels), stage_rows=stage_rows,
                        leaf_groups=tuple(leaf_groups), has_one=has_one)


_LEVEL_FNS: dict = {}


def _leveled_fn(key, lp: LevelProgram, nb: int, device,
                stride: int = STRIDE):
    """One-block evaluator with the level program's index tables on `device`.

    Signature: fn(srcs, start, S, W) -> (nb, 4) Montgomery int32.
    srcs: per leaf-group source, an LDE row array whose rows
    [start, start + nb + stride) are the block and its next-trace-row
    overhang (distinct group names, first-use order). S: standard-form
    int64 scalars; W: (n_stage, 4) standard-form int64 alpha powers.
    stride: rows per +1 trace-row leaf offset (STRIDE on the blowup-4
    LDE; 1 when the sources hold one coset's evaluations).
    """
    fkey = (key, nb, str(device), stride)
    fn = _LEVEL_FNS.get(fkey)
    if fn is not None:
        return fn

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    leaf_groups = [(off, t(cols), len(cols))
                   for _, off, cols in lp.leaf_groups]
    src_of = []
    gnames = []
    for g, _, _ in lp.leaf_groups:
        if g not in gnames:
            gnames.append(g)
        src_of.append(gnames.index(g))
    levels = [(off, t(m_ia), t(m_ib), t(l_ia), t(l_ib), t(l_sa), t(l_sb))
              for (off, m_ia, m_ib, l_ia, l_ib, l_sa, l_sb) in lp.levels]
    stage_rows = t(lp.stage_rows)

    def fn(srcs, start, S, W):
        B = torch.empty((lp.n_rows, nb), dtype=torch.int32, device=device)
        row = 0
        if lp.has_one:
            B[0] = F.mont_one()
            row = 1
        for (off, cols, k), si in zip(leaf_groups, src_of):
            lo = start + stride * off
            sub = srcs[si][lo:lo + nb]
            B[row:row + k] = sub.index_select(1, cols).T
            row += k
        for (off, m_ia, m_ib, l_ia, l_ib, l_sa, l_sb) in levels:
            nm, nl = m_ia.shape[0], l_ia.shape[0]
            if nm:
                B[off:off + nm] = F.mul(B.index_select(0, m_ia),
                                        B.index_select(0, m_ib))
            if nl:
                # s_a*A + s_b*B with standard-form scalars: each product
                # is < p^2, the sum < 2^63, one reduction
                va = B.index_select(0, l_ia).to(torch.int64)
                va *= S[l_sa][:, None]
                vb = B.index_select(0, l_ib).to(torch.int64)
                vb *= S[l_sb][:, None]
                B[off + nm:off + nm + nl] = torch.fmod(va.add_(vb), P)
        stage = B.index_select(0, stage_rows).to(torch.int64)
        acc = [torch.fmod(torch.fmod(stage * W[:, c][:, None], P).sum(dim=0),
                          P) for c in range(4)]
        return torch.stack(acc, dim=1).to(torch.int32)

    _LEVEL_FNS[fkey] = fn
    return fn


def max_offset(tp: TapeProgram) -> int:
    """The largest trace-row offset of any leaf of the tape."""
    return max((off for _, _, off in tp.leaves), default=0)


def eval_check(tp: TapeProgram, ldes: dict, publics, challenges,
               alpha_pows_std: np.ndarray, stride: int = STRIDE,
               halo: dict | None = None, single_block: bool = False):
    """Evaluate acc(x) = sum_i alpha^i * C_i(x) over the whole LDE domain.

    Returns an (N, 4) Montgomery int32 tensor (N = LDE rows). Rows are
    evaluated in blocks sized so that the level buffer (n_rows x nb
    int32) holds about ``BLOCK_ELEMS`` elements; the result does not
    depend on the block size. stride: LDE rows per +1 trace-row leaf
    offset -- STRIDE for blowup-4 LDEs, 1 when `ldes` holds a single
    coset's (n, c) evaluations (the streamed main group evaluates the
    check polynomial coset by coset; a strided view ``lde[r::4]`` of a
    resident LDE serves as coset r without a copy).

    halo: with `ldes` one rank's contiguous row block of sharded LDEs,
    per group the ``stride * max_offset(tp)`` rows that follow the block
    (the next rank's first rows, cyclically): the block's last rows read
    their next-trace-row leaves there instead of wrapping to the block's
    own first rows. The result is then this block's rows of the whole
    domain's evaluation. single_block: the whole domain in one call of
    the op-by-op interpreter (``run_block`` over ``build_leafmat``), the
    reference's mesh evaluator.
    """
    lde0 = next(iter(ldes.values()))
    device = lde0.device
    n = lde0.shape[0]
    if single_block:
        S = torch.as_tensor(eval_scalars(tp, publics, challenges)
                            .view(np.int32), device=device)
        W = torch.as_tensor(_to_monty_np(np.asarray(
            alpha_pows_std, np.uint64)[:tp.n_stage]).view(np.int32),
            device=device)
        return run_block(build_leafmat(tp.leaves, ldes, stride), tp, S, W)
    lp = _level_program(tp)
    S = torch.as_tensor(H.from_monty_np(eval_scalars(tp, publics, challenges))
                        .astype(np.int64), device=device)
    W = torch.as_tensor(np.asarray(alpha_pows_std, np.uint64)[:tp.n_stage]
                        .astype(np.int64), device=device)
    target = max(4096, BLOCK_ELEMS // max(lp.n_rows, 1))
    nb = min(n, BLOCK_ROWS, 1 << (target.bit_length() - 1))
    gnames = []
    for g, off, cols in lp.leaf_groups:
        if g not in gnames:
            gnames.append(g)
    # interior blocks slice (nb + stride) rows straight from the LDEs (the
    # +1-trace-row leaf offset never crosses the end); only the final
    # block wraps, through a small (nb + stride, c) tail copy per group
    raw = tuple(ldes[g] for g in gnames)
    fn = _leveled_fn(id(tp), lp, nb, device, stride)
    out = torch.empty((n, 4), dtype=torch.int32, device=device)
    for start in range(0, n - nb, nb):
        out[start:start + nb] = fn(raw, start, S, W)
    if halo is None:
        tails = tuple(_wrap_tail(ldes[g], nb, stride) for g in gnames)
    else:
        tails = tuple(torch.cat([ldes[g][n - nb:], halo[g]], dim=0)
                      for g in gnames)
    out[n - nb:] = fn(tails, 0, S, W)
    return out


def _wrap_tail(lde, nb: int, stride: int = STRIDE):
    """Last (nb) LDE rows extended by the first `stride` (wrap block)."""
    return torch.cat([lde[lde.shape[0] - nb:], lde[:stride]], dim=0)


# ---------------------------------------------------------------------------
# The op-by-op interpreter (the reference's scan interpreter)
# ---------------------------------------------------------------------------
#
# The reference's mesh path evaluates the tape op by op over one block of
# rows (``_run_block``, a scan over the (T, 6) op rows). Here it is a
# second evaluator beside the level schedule, with the reference's layout:
# a register file B of [regs | stage | leaves] rows by block rows.


def build_leafblock(specs, ldes: dict, start: int, nb: int,
                    stride: int = STRIDE):
    """(nb, n_leaves) Montgomery leaf matrix for LDE rows [start,
    start + nb), wrapping at the end of the domain. specs: the tape's
    (group, col, offset) leaves; '__one__' is the constant-one leaf."""
    lde0 = next(iter(ldes.values()))
    n = lde0.shape[0]
    rows = (torch.arange(nb, device=lde0.device) + start) % n
    out = torch.empty((nb, len(specs)), dtype=torch.int32,
                      device=lde0.device)
    for i, (g, c, off) in enumerate(specs):
        if g == "__one__":
            out[:, i] = F.mont_one()
        else:
            out[:, i] = ldes[g][(rows + stride * off) % n, c]
    return out


def build_leafmat(specs, ldes: dict, stride: int = STRIDE):
    """(N, n_leaves) Montgomery leaf matrix over the whole domain."""
    n = next(iter(ldes.values())).shape[0]
    return build_leafblock(specs, ldes, 0, n, stride)


def run_block(leaf_block, tp: TapeProgram, S, W):
    """Interpret the tape op by op over one block of rows.

    leaf_block: (nb, n_leaves) Montgomery; S: (s,) Montgomery scalars;
    W: (n_stage, 4) Montgomery alpha powers. Each op writes
    ``A*B`` (OP_MUL) or ``S[sa]*A + S[sb]*B`` (OP_LINC) into row dst of
    the register file. Returns the (nb, 4) alpha-mix of the stage rows."""
    nb = leaf_block.shape[0]
    B = torch.cat([torch.zeros((tp.n_regs + tp.n_stage, nb),
                               dtype=torch.int32, device=leaf_block.device),
                   leaf_block.T], dim=0)
    for opc, a, b, sa, sb, dst in tp.ops.tolist():
        if opc == OP_MUL:
            B[dst] = F.mul(B[a], B[b])
        else:
            B[dst] = F.add(F.mul(S[sa], B[a]), F.mul(S[sb], B[b]))
    stage = B[tp.n_regs:tp.n_regs + tp.n_stage].to(torch.int64)
    acc = [torch.fmod(F.mul(stage, W[:, c][:, None]).to(torch.int64)
                      .sum(dim=0), P) for c in range(4)]
    return torch.stack(acc, dim=1).to(torch.int32)


_LEVEL_PROGS: dict = {}


def _level_program(tp: TapeProgram) -> LevelProgram:
    lp = _LEVEL_PROGS.get(id(tp))
    if lp is None:
        lp = build_levels(tp)
        _LEVEL_PROGS[id(tp)] = lp
    return lp
