"""C99 -> RV32IM compiler for zkVM guest programs.

Replaces the reference's guest cross-compilation step (SURVEY.md §2.1
`guests` build crate, guests/build.rs:18-55; no RISC-V toolchain exists in
this environment, so the stateless-client guest — the program role of
guests/stateless-client/src/lib.rs:21-34 — is written in C99 and
compiled in-tree). Deliberately simple, correctness-first codegen:

  - all integer arithmetic is 32-bit (char/short promote; no 64-bit
    integer types — guest code uses 32-bit limbs, e.g. u256 = 8 x u32);
  - expression temporaries live in t0..t6 and spill to the frame; a
    pin discipline keeps multi-operand sites safe, and all live temps
    are spilled to frame slots before any conditional region so every
    runtime path sees the same canonical locations;
  - locals always live on the frame (s0 = frame top, negative offsets);
  - args in a0..a7 (max 8, each <= 4 bytes or pointer), return in a0;
  - structs/unions/arrays as objects (member access, pointers, struct
    assignment); struct-by-value args/returns are rejected — guest
    code passes pointers;
  - conditional branches are emitted long-form (inverted branch over a
    jal) unless the target is a known near backward label, so function
    bodies larger than the +-4KB B-type range are safe;
  - switch dispatch is a balanced binary compare tree (the EVM
    interpreter's opcode dispatch stays O(log n) cycles).

Output: one self-contained ELF — crt0 (sets sp/s0, calls main, halts
with main's return code), all functions, then .data/.bss.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

from pycparser import c_ast, c_parser

from ..executor.assembler import Asm, _enc_b, _enc_i, _enc_r, _enc_s, _enc_u
from ..executor.elf import write_elf


class CompileError(Exception):
    pass


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------

class CType:
    size = 4
    align = 4
    signed = False

    def is_int(self):
        return isinstance(self, IntT)

    def is_ptr(self):
        return isinstance(self, PtrT)

    def is_arr(self):
        return isinstance(self, ArrT)

    def is_struct(self):
        return isinstance(self, StructT)

    def is_func(self):
        return isinstance(self, FuncT)

    def is_void(self):
        return isinstance(self, VoidT)

    def is_scalar(self):
        return self.is_int() or self.is_ptr()


class VoidT(CType):
    size = 0
    align = 1

    def __repr__(self):
        return "void"


class IntT(CType):
    def __init__(self, size, signed):
        self.size = size
        self.align = size
        self.signed = signed

    def __repr__(self):
        return f"{'i' if self.signed else 'u'}{self.size * 8}"


class PtrT(CType):
    size = 4
    align = 4

    def __init__(self, to):
        self.to = to

    def __repr__(self):
        return f"{self.to}*"


class ArrT(CType):
    def __init__(self, elem, n):
        self.elem = elem
        self.n = n
        self.size = elem.size * n if n is not None else 0
        self.align = elem.align

    def __repr__(self):
        return f"{self.elem}[{self.n}]"


class StructT(CType):
    def __init__(self, name, is_union=False):
        self.name = name
        self.is_union = is_union
        self.fields: dict[str, tuple[int, CType]] = {}
        self.size = 0
        self.align = 1
        self.complete = False

    def set_fields(self, fields):
        off = 0
        align = 1
        for fname, ftype in fields:
            if ftype.size == 0 and not ftype.is_arr():
                raise CompileError(f"incomplete field {fname} in {self.name}")
            align = max(align, ftype.align)
            if self.is_union:
                self.fields[fname] = (0, ftype)
                off = max(off, ftype.size)
            else:
                foff = (off + ftype.align - 1) & ~(ftype.align - 1)
                self.fields[fname] = (foff, ftype)
                off = foff + ftype.size
        self.align = align
        self.size = (off + align - 1) & ~(align - 1)
        self.complete = True

    def __repr__(self):
        return f"{'union' if self.is_union else 'struct'} {self.name}"


class FuncT(CType):
    def __init__(self, ret, params):
        self.ret = ret
        self.params = params

    def __repr__(self):
        return f"{self.ret}(...)"


I32 = IntT(4, True)
U32 = IntT(4, False)
I16 = IntT(2, True)
U16 = IntT(2, False)
I8 = IntT(1, True)
U8 = IntT(1, False)
VOID = VoidT()

_BASE_TYPES = {
    ("void",): VOID,
    ("char",): I8,
    ("signed", "char"): I8,
    ("unsigned", "char"): U8,
    ("short",): I16, ("short", "int"): I16,
    ("signed", "short"): I16, ("signed", "short", "int"): I16,
    ("unsigned", "short"): U16, ("unsigned", "short", "int"): U16,
    ("int",): I32, ("signed",): I32, ("signed", "int"): I32,
    ("unsigned",): U32, ("unsigned", "int"): U32,
    ("long",): I32, ("long", "int"): I32, ("signed", "long"): I32,
    ("signed", "long", "int"): I32,
    ("unsigned", "long"): U32, ("unsigned", "long", "int"): U32,
    ("_Bool",): U8,
}

_BR_F3 = {"beq": 0, "bne": 1, "blt": 4, "bge": 5, "bltu": 6, "bgeu": 7}
_BR_INV = {"beq": "bne", "bne": "beq", "blt": "bge", "bge": "blt",
           "bltu": "bgeu", "bgeu": "bltu"}


def _c_unescape(s: str) -> bytes:
    out = bytearray()
    i = 0
    while i < len(s):
        c = s[i]
        if c != "\\":
            out += c.encode("utf-8")
            i += 1
            continue
        i += 1
        e = s[i]
        simple = {"n": 10, "t": 9, "r": 13, "\\": 92, "'": 39,
                  '"': 34, "a": 7, "b": 8, "f": 12, "v": 11, "?": 63}
        if e == "x":
            j = i + 1
            while j < len(s) and s[j] in "0123456789abcdefABCDEF":
                j += 1
            out.append(int(s[i + 1:j], 16) & 0xFF)
            i = j
        elif e in "01234567":
            j = i
            while j < len(s) and j < i + 3 and s[j] in "01234567":
                j += 1
            out.append(int(s[i:j], 8) & 0xFF)
            i = j
        elif e in simple:
            out.append(simple[e])
            i += 1
        else:
            raise CompileError(f"bad escape \\{e}")
    return bytes(out)


class Tmp:
    """An expression temporary: in a register, or spilled to a frame slot."""

    __slots__ = ("reg", "slot", "type", "pinned")

    def __init__(self, reg, ctype):
        self.reg = reg
        self.slot = None
        self.type = ctype
        self.pinned = False


class Var:
    def __init__(self, kind, ctype, off=None, sym=None):
        self.kind = kind      # "local" | "global" | "func" | "enum"
        self.type = ctype
        self.off = off
        self.sym = sym
        self.value = None


class _Data:
    def __init__(self, sym, size, align):
        self.sym = sym
        self.size = size
        self.align = max(align, 4)
        self.bytes = bytearray(size)
        self.relocs = []      # (offset, symbol, addend)
        self.addr = None


TMP_REGS = ["t0", "t1", "t2", "t3", "t4", "t5", "t6"]
ARG_REGS = ["a0", "a1", "a2", "a3", "a4", "a5", "a6", "a7"]
_PROLOGUE_WORDS = 7


class Compiler:
    def __init__(self, org=0x10000, stack_top=0x0400_0000):
        self.asm = Asm(org=org)
        self.org = org
        self.stack_top = stack_top
        self.globals: dict[str, Var] = {}
        self.structs: dict[str, StructT] = {}
        # anonymous-struct naming: keyed by node identity, with the node
        # PINNED so a freed AST node's address can never be reused by a
        # later file's struct (an id() collision silently aliased two
        # different anonymous structs — wrong size/fields)
        self._anon_names: dict[int, str] = {}
        self._anon_pins: list = []
        self.typedefs: dict[str, CType] = {}
        self.data: list[_Data] = []
        self.strlits: dict[bytes, str] = {}
        self.label_n = 0
        self.emitted_funcs: set[str] = set()
        self.needed_funcs: set[str] = set()
        self._reset_func()

    def _reset_func(self):
        self.frame = 8            # [-4]=saved ra, [-8]=saved s0
        self.frame_max = 8
        self.spill_next = 0       # sp-relative spill band high-water
        self.locals_scopes = []
        self.live: list[Tmp] = []
        self.free_regs = list(TMP_REGS)
        self.spill_free: list[int] = []
        self.break_stack = []
        self.cont_stack = []
        self.cur_ret = VOID
        self.func_name = None

    # -- misc ----------------------------------------------------------------

    def lbl(self, hint=""):
        self.label_n += 1
        return f".L{self.label_n}_{hint}"

    def err(self, node, msg):
        raise CompileError(f"{getattr(node, 'coord', None)}: {msg}")

    # -- long-range conditional branch ----------------------------------------

    def cbr(self, kind, ra, rb, label):
        """Conditional branch with unlimited range: short form when the
        target is a known near backward label, else inverted-branch+jal."""
        a = self.asm
        tgt = a.labels.get(label)
        if tgt is not None:
            dist = tgt - a.pc()
            if -4000 <= dist < 4000:
                getattr(a, kind)(ra, rb, label)
                return
        a._emit(_enc_b(0x63, _BR_F3[_BR_INV[kind]], ra, rb, 8))
        a.jal("zero", label)

    # -- type resolution -------------------------------------------------------

    def type_of_decl(self, node):
        if isinstance(node, c_ast.TypeDecl):
            return self.type_of_decl(node.type)
        if isinstance(node, c_ast.IdentifierType):
            names = tuple(n for n in node.names
                          if n not in ("const", "volatile"))
            if len(names) == 1 and names[0] in self.typedefs:
                return self.typedefs[names[0]]
            if names in _BASE_TYPES:
                return _BASE_TYPES[names]
            if names.count("long") >= 2:
                raise CompileError(
                    f"64-bit integers unsupported ({node.names}); "
                    "guest code uses 32-bit limbs")
            raise CompileError(f"unknown type {node.names}")
        if isinstance(node, c_ast.PtrDecl):
            return PtrT(self.type_of_decl(node.type))
        if isinstance(node, c_ast.ArrayDecl):
            elem = self.type_of_decl(node.type)
            n = self.const_expr(node.dim) if node.dim is not None else None
            return ArrT(elem, n)
        if isinstance(node, (c_ast.Struct, c_ast.Union)):
            return self.struct_type(node)
        if isinstance(node, c_ast.Enum):
            self.enum_type(node)
            return I32
        if isinstance(node, c_ast.FuncDecl):
            ret = self.type_of_decl(node.type)
            params = []
            if node.args:
                for p in node.args.params:
                    if isinstance(p, c_ast.EllipsisParam):
                        raise CompileError("varargs not supported")
                    pt = self.type_of_decl(p.type)
                    if pt.is_void():
                        continue
                    if pt.is_arr():
                        pt = PtrT(pt.elem)
                    params.append(pt)
            return FuncT(ret, params)
        if isinstance(node, c_ast.Typename):
            return self.type_of_decl(node.type)
        raise CompileError(f"unhandled type node {type(node).__name__}")

    def struct_type(self, node):
        is_union = isinstance(node, c_ast.Union)
        name = node.name
        if name is None:
            name = self._anon_names.get(id(node))
            if name is None:
                name = f"__anon{len(self._anon_names)}"
                self._anon_names[id(node)] = name
                self._anon_pins.append(node)
        key = ("union " if is_union else "struct ") + name
        st = self.structs.get(key)
        if st is None:
            st = StructT(name, is_union)
            self.structs[key] = st
        if node.decls is not None and not st.complete:
            fields = []
            for d in node.decls:
                if d.name is None:
                    raise CompileError("anonymous struct fields unsupported")
                fields.append((d.name, self.type_of_decl(d.type)))
            st.set_fields(fields)
        return st

    def enum_type(self, node):
        if node.values is None:
            return
        nxt = 0
        for e in node.values.enumerators:
            if e.value is not None:
                nxt = self.const_expr(e.value)
                nxt = nxt - (1 << 32) if nxt & 0x80000000 else nxt
            v = Var("enum", I32)
            v.value = nxt & 0xFFFFFFFF
            self.globals[e.name] = v
            nxt += 1

    # -- constant expressions ----------------------------------------------

    def const_expr(self, node):
        v = self._const(node)
        if isinstance(v, tuple):
            raise CompileError("address constant where integer needed")
        return v

    def _const(self, node):
        """Constant expression -> int (mod 2^32), or (symbol, addend)."""
        if isinstance(node, c_ast.Constant):
            if node.type == "char":
                return _c_unescape(node.value[1:-1])[0]
            if node.type == "string":
                return (self.string_lit(node), 0)
            if "int" in node.type:
                return int(node.value.rstrip("uUlL"), 0) & 0xFFFFFFFF
            raise CompileError(f"bad constant type {node.type}")
        if isinstance(node, c_ast.UnaryOp):
            if node.op == "sizeof":
                if isinstance(node.expr, c_ast.Typename):
                    return self.type_of_decl(node.expr).size
                return self.expr_type(node.expr).size
            if node.op == "&":
                if isinstance(node.expr, c_ast.ID):
                    g = self.globals.get(node.expr.name)
                    if g and g.kind == "global":
                        return (g.sym, 0)
                raise CompileError("non-constant address")
            if node.op not in ("-", "+", "~", "!"):
                raise CompileError(f"non-constant unary {node.op}")
            a = self._const(node.expr)
            if isinstance(a, tuple):
                raise CompileError("address arithmetic in const expr")
            return {"-": (-a) & 0xFFFFFFFF, "+": a,
                    "~": (~a) & 0xFFFFFFFF, "!": int(a == 0)}[node.op]
        if isinstance(node, c_ast.BinaryOp):
            a = self._const(node.left)
            b = self._const(node.right)
            if isinstance(a, tuple) or isinstance(b, tuple):
                raise CompileError("address arithmetic in const expr")
            ops = {"+": a + b, "-": a - b, "*": a * b,
                   "/": a // b if b else 0, "%": a % b if b else 0,
                   "<<": a << (b & 31), ">>": a >> (b & 31),
                   "&": a & b, "|": a | b, "^": a ^ b,
                   "==": int(a == b), "!=": int(a != b),
                   "<": int(a < b), ">": int(a > b),
                   "<=": int(a <= b), ">=": int(a >= b),
                   "&&": int(bool(a) and bool(b)),
                   "||": int(bool(a) or bool(b))}
            if node.op not in ops:
                raise CompileError(f"non-constant binop {node.op}")
            return ops[node.op] & 0xFFFFFFFF
        if isinstance(node, c_ast.Cast):
            t = self.type_of_decl(node.to_type)
            v = self._const(node.expr)
            if isinstance(v, tuple):
                return v
            if t.is_int() and t.size < 4:
                v &= (1 << (8 * t.size)) - 1
            return v
        if isinstance(node, c_ast.ID):
            g = self.globals.get(node.name)
            if g and g.kind == "enum":
                return g.value
            if g and g.kind == "global" and g.type.is_arr():
                return (g.sym, 0)
            if g and g.kind == "func":
                self.needed_funcs.add(g.sym)
                return (g.sym, 0)
            raise CompileError(f"non-constant identifier {node.name}")
        if isinstance(node, c_ast.TernaryOp):
            return (self._const(node.iftrue) if self.const_expr(node.cond)
                    else self._const(node.iffalse))
        raise CompileError(f"non-constant expr {type(node).__name__}")

    def _fold(self, node):
        if isinstance(node, (c_ast.Assignment, c_ast.FuncCall)):
            return None
        try:
            v = self._const(node)
        except CompileError:
            return None
        return None if isinstance(v, tuple) else v

    # -- expression types ------------------------------------------------------

    def expr_type(self, node):
        if isinstance(node, c_ast.ID):
            return self.lookup(node.name).type
        if isinstance(node, c_ast.Constant):
            if node.type == "string":
                return PtrT(I8)
            return I32
        if isinstance(node, c_ast.ArrayRef):
            t = self.expr_type(node.name)
            return t.elem if t.is_arr() else t.to
        if isinstance(node, c_ast.StructRef):
            base = self.expr_type(node.name)
            st = base.to if node.type == "->" else base
            if st.is_arr():
                st = st.elem
            if not st.is_struct():
                self.err(node, f"member of non-struct {st}")
            if node.field.name not in st.fields:
                self.err(node, f"no field {node.field.name} in {st}")
            return st.fields[node.field.name][1]
        if isinstance(node, c_ast.UnaryOp):
            if node.op == "*":
                t = self.expr_type(node.expr)
                return t.elem if t.is_arr() else t.to
            if node.op == "&":
                return PtrT(self.expr_type(node.expr))
            if node.op == "sizeof":
                return U32
            if node.op == "!":
                return I32
            return self.expr_type(node.expr)
        if isinstance(node, c_ast.Cast):
            return self.type_of_decl(node.to_type)
        if isinstance(node, c_ast.BinaryOp):
            if node.op in ("==", "!=", "<", ">", "<=", ">=", "&&", "||"):
                return I32
            lt = self.expr_type(node.left)
            rt = self.expr_type(node.right)
            if lt.is_ptr() or lt.is_arr():
                if node.op == "-" and (rt.is_ptr() or rt.is_arr()):
                    return I32
                return PtrT(lt.elem) if lt.is_arr() else lt
            if rt.is_ptr() or rt.is_arr():
                return PtrT(rt.elem) if rt.is_arr() else rt
            if lt.is_int() and rt.is_int():
                return U32 if (not lt.signed or not rt.signed) else I32
            return lt
        if isinstance(node, c_ast.TernaryOp):
            return self.expr_type(node.iftrue)
        if isinstance(node, c_ast.FuncCall):
            if isinstance(node.name, c_ast.ID) and \
                    node.name.name in ("__ecall", "__mulhu"):
                return U32
            if isinstance(node.name, c_ast.ID) and \
                    node.name.name in ("__mulh", "__mulhsu"):
                return I32
            ft = self.expr_type(node.name)
            if ft.is_ptr():
                ft = ft.to
            return ft.ret
        if isinstance(node, c_ast.Assignment):
            return self.expr_type(node.lvalue)
        if isinstance(node, c_ast.ExprList):
            return self.expr_type(node.exprs[-1])
        raise CompileError(f"expr_type: unhandled {type(node).__name__}")

    # -- registers / spilling ----------------------------------------------

    def alloc_slot(self):
        """Spill slots live in an sp-relative band at the frame bottom
        (non-negative offsets), disjoint from the s0-relative scoped
        locals, so scope-watermark reuse cannot alias a live slot."""
        if self.spill_free:
            return self.spill_free.pop()
        off = 4 * self.spill_next
        self.spill_next += 1
        if off >= 2048:
            raise CompileError("spill band overflow")
        return off

    def take_reg(self):
        if self.free_regs:
            return self.free_regs.pop(0)
        for t in self.live:
            if t.reg is not None and not t.pinned:
                t.slot = self.alloc_slot()
                self.store_frame(t.reg, t.slot)
                r = t.reg
                t.reg = None
                return r
        raise CompileError("register pressure: all temps pinned")

    def new_tmp(self, ctype):
        r = self.take_reg()
        t = Tmp(r, ctype)
        self.live.append(t)
        return t

    def reg_of(self, t: Tmp, pin=False):
        if t.reg is None:
            t.reg = self.take_reg()
            self.load_frame(t.reg, t.slot)
            self.spill_free.append(t.slot)
            t.slot = None
        if pin:
            t.pinned = True
        return t.reg

    def free(self, t: Tmp):
        if t in self.live:
            self.live.remove(t)
        if t.reg is not None:
            self.free_regs.insert(0, t.reg)
        elif t.slot is not None:
            self.spill_free.append(t.slot)
        t.reg = t.slot = None
        t.pinned = False

    def spill_all(self):
        """Spill every live unpinned temp to its frame slot (canonical
        location on all runtime paths — required before conditional
        regions). Pinned temps stay put: nothing may displace them, so
        their register is the canonical location on every path."""
        for t in self.live:
            if t.reg is not None and not t.pinned:
                t.slot = self.alloc_slot()
                self.store_frame(t.reg, t.slot)
                self.free_regs.insert(0, t.reg)
                t.reg = None

    def slot_tmp(self, ctype):
        """A temp pinned to a frame slot (branch-join result carrier)."""
        t = Tmp(None, ctype)
        t.slot = self.alloc_slot()
        self.live.append(t)
        return t

    # -- frame access ----------------------------------------------------------

    def store_frame(self, reg, off):
        self._frame_access("sw", reg, off)

    def load_frame(self, reg, off):
        self._frame_access("lw", reg, off)

    def _frame_access(self, op, reg, off):
        a = self.asm
        if off >= 0:                      # spill band: sp-relative
            getattr(a, op)(reg, "sp", off)
        elif off >= -2048:
            getattr(a, op)(reg, "s0", off)
        else:
            raise CompileError(f"frame too large ({off}); "
                               "move large arrays to globals or the heap")

    def frame_addr(self, reg, off):
        a = self.asm
        if 0 > off >= -2048:
            a.addi(reg, "s0", off)
        else:
            raise CompileError(f"frame too large ({off})")

    # -- scopes ------------------------------------------------------------

    def push_scope(self):
        self.locals_scopes.append({"__watermark__": self.frame})

    def pop_scope(self):
        sc = self.locals_scopes.pop()
        self.frame = sc["__watermark__"]

    def declare_local(self, name, ctype):
        size = max(4, (ctype.size + 3) & ~3)
        self.frame += size
        self.frame_max = max(self.frame_max, self.frame)
        v = Var("local", ctype, off=-self.frame)
        self.locals_scopes[-1][name] = v
        return v

    def lookup(self, name):
        for sc in reversed(self.locals_scopes):
            if name in sc and name != "__watermark__":
                return sc[name]
        if name in self.globals:
            return self.globals[name]
        raise CompileError(f"undeclared identifier {name}")

    # -- globals -----------------------------------------------------------

    def string_lit(self, node):
        b = _c_unescape(node.value[1:-1]) + b"\x00"
        if b in self.strlits:
            return self.strlits[b]
        sym = f"__str{len(self.strlits)}"
        d = _Data(sym, len(b), 4)
        d.bytes[:] = b
        self.data.append(d)
        self.strlits[b] = sym
        return sym

    def emit_global(self, name, ctype, init):
        sym = f"g_{name}"
        for d0 in self.data:
            if d0.sym == sym:      # tentative definition already emitted
                v = self.globals.get(name)
                if v is None or v.kind != "global":
                    v = Var("global", ctype, sym=sym)
                    self.globals[name] = v
                if init is not None:
                    self._init_data(d0, 0, ctype, init)
                return v
        d = _Data(sym, max(ctype.size, 4), ctype.align)
        if init is not None:
            self._init_data(d, 0, ctype, init)
        self.data.append(d)
        v = Var("global", ctype, sym=sym)
        self.globals[name] = v
        return v

    def _init_data(self, d, off, ctype, init):
        if isinstance(init, c_ast.InitList):
            if ctype.is_arr():
                for i, e in enumerate(init.exprs):
                    self._init_data(d, off + i * ctype.elem.size,
                                    ctype.elem, e)
            elif ctype.is_struct():
                names = list(ctype.fields)
                i = 0
                for e in init.exprs:
                    if isinstance(e, c_ast.NamedInitializer):
                        fname = e.name[0].name
                        foff, ft = ctype.fields[fname]
                        self._init_data(d, off + foff, ft, e.expr)
                        i = names.index(fname) + 1
                    else:
                        foff, ft = ctype.fields[names[i]]
                        self._init_data(d, off + foff, ft, e)
                        i += 1
            else:
                self._init_data(d, off, ctype, init.exprs[0])
            return
        if (ctype.is_arr() and ctype.elem.size == 1
                and isinstance(init, c_ast.Constant)
                and init.type == "string"):
            b = _c_unescape(init.value[1:-1]) + b"\x00"
            d.bytes[off:off + len(b)] = b
            return
        v = self._const(init)
        if isinstance(v, tuple):
            d.relocs.append((off, v[0], v[1]))
            return
        size = ctype.size if ctype.size in (1, 2, 4) else 4
        d.bytes[off:off + size] = int(v & ((1 << (8 * size)) - 1)).to_bytes(
            size, "little")

    # =======================================================================
    # program assembly
    # =======================================================================

    def compile(self, asts):
        a = self.asm
        # crt0
        a.li("sp", self.stack_top)
        a.li("s0", self.stack_top)
        a.jal("ra", "main")
        a.li("a7", 0)
        a.ecall()
        self.needed_funcs.add("main")

        funcdefs = []
        for ast in asts:
            for ext in ast.ext:
                if isinstance(ext, c_ast.Typedef):
                    self.typedefs[ext.name] = self.type_of_decl(ext.type)
                elif isinstance(ext, c_ast.FuncDef):
                    name = ext.decl.name
                    ft = self.type_of_decl(ext.decl.type)
                    self.globals[name] = Var("func", ft, sym=name)
                    funcdefs.append(ext)
                elif isinstance(ext, c_ast.Decl):
                    self.top_decl(ext)
                elif isinstance(ext, c_ast.Pragma):
                    pass
                else:
                    raise CompileError(
                        f"unhandled top-level {type(ext).__name__}")
        for fd in funcdefs:
            self.gen_func(fd)

        missing = self.needed_funcs - self.emitted_funcs
        if missing:
            raise CompileError(f"undefined functions: {sorted(missing)}")

        # .data layout after .text
        code_end = self.org + 4 * len(a.items)
        blob_start = (code_end + 15) & ~15
        base = blob_start
        for d in self.data:
            base = (base + d.align - 1) & ~(d.align - 1)
            d.addr = base
            base += d.size
        for d in self.data:
            a.labels[d.sym] = d.addr
        blob = bytearray(base - blob_start)
        for d in self.data:
            o = d.addr - blob_start
            blob[o:o + d.size] = d.bytes
            for off, sym, add in d.relocs:
                tgt = a.labels.get(sym)
                if tgt is None:
                    raise CompileError(f"unresolved data reloc {sym}")
                blob[o + off:o + off + 4] = \
                    ((tgt + add) & 0xFFFFFFFF).to_bytes(4, "little")
        if base >= 0x00E0_0000:
            raise CompileError("data section collides with the stack region")

        code = a.assemble()
        segs = [(self.org, code)]
        if blob:
            segs.append((blob_start, bytes(blob)))
        return write_elf(segs, self.org)

    def top_decl(self, decl):
        t = self.type_of_decl(decl.type)
        if t.is_func():
            if decl.name:
                self.globals.setdefault(decl.name,
                                        Var("func", t, sym=decl.name))
            return
        if decl.name is None:
            return
        if "extern" in (decl.storage or []):
            if decl.name not in self.globals:
                self.globals[decl.name] = \
                    Var("global", t, sym=f"g_{decl.name}")
            return
        t = self._complete_array(t, decl.init)
        self.emit_global(decl.name, t, decl.init)

    @staticmethod
    def _complete_array(t, init):
        if t.is_arr() and t.n is None and init is not None:
            if isinstance(init, c_ast.InitList):
                return ArrT(t.elem, len(init.exprs))
            if isinstance(init, c_ast.Constant) and init.type == "string":
                return ArrT(t.elem,
                            len(_c_unescape(init.value[1:-1])) + 1)
        return t

    def la(self, rd, sym):
        a = self.asm
        a._emit_fix(lambda pc, tgt, rd=rd:
                    _enc_u(0x37, rd, (tgt + 0x800) & 0xFFFFF000), sym)
        a._emit_fix(lambda pc, tgt, rd=rd:
                    _enc_i(0x13, rd, 0, rd, tgt & 0xFFF), sym)

    # -- functions ------------------------------------------------------------

    def gen_func(self, fd):
        a = self.asm
        self._reset_func()
        name = fd.decl.name
        self.func_name = name
        ft = self.globals[name].type
        self.cur_ret = ft.ret
        if ft.ret.is_struct():
            raise CompileError(f"{name}: struct return unsupported "
                               "(use an out-pointer)")
        self.emitted_funcs.add(name)

        a.label(name)
        patch_at = len(a.items)
        for _ in range(_PROLOGUE_WORDS):
            a.nop()

        self.push_scope()
        params = []
        if fd.decl.type.args:
            for p in fd.decl.type.args.params:
                pt = self.type_of_decl(p.type)
                if pt.is_void():
                    continue
                if pt.is_arr():
                    pt = PtrT(pt.elem)
                if pt.is_struct():
                    raise CompileError(
                        f"{name}: struct-by-value param unsupported")
                params.append((p.name, pt))
        if len(params) > 8:
            raise CompileError(f"{name}: more than 8 parameters")
        for i, (pname, pt) in enumerate(params):
            v = self.declare_local(pname, pt)
            self.store_frame(ARG_REGS[i], v.off)

        self.gen_stmt(fd.body)
        self.pop_scope()
        if not self.cur_ret.is_void():
            a.li("a0", 0)
        self.gen_return()

        # patch the prologue now the frame size is final: scoped locals
        # below s0, spill band above sp, no overlap
        frame = (self.frame_max + 4 * self.spill_next + 15) & ~15
        if frame >= 2048:
            raise CompileError(
                f"{name}: frame {frame}B too large; move arrays off-stack")
        R = {"t0": 5, "sp": 2, "ra": 1, "s0": 8}
        a.items[patch_at + 0] = _enc_u(0x37, R["t0"],
                                       (frame + 0x800) & 0xFFFFF000)
        a.items[patch_at + 1] = _enc_i(0x13, R["t0"], 0, R["t0"],
                                       frame & 0xFFF)
        a.items[patch_at + 2] = _enc_r(0x33, R["sp"], 0, R["sp"],
                                       R["t0"], 0x20)   # sub sp, sp, t0
        a.items[patch_at + 3] = _enc_r(0x33, R["t0"], 0, R["sp"],
                                       R["t0"], 0)      # add t0, sp, t0
        a.items[patch_at + 4] = _enc_s(0x23, 2, R["t0"], R["ra"], -4)
        a.items[patch_at + 5] = _enc_s(0x23, 2, R["t0"], R["s0"], -8)
        a.items[patch_at + 6] = _enc_i(0x13, R["s0"], 0, R["t0"], 0)

    def gen_return(self):
        a = self.asm
        a.lw("ra", "s0", -4)
        a.mv("sp", "s0")
        a.lw("s0", "s0", -8)
        a.jalr("zero", "ra", 0)

    # -- statements -------------------------------------------------------------

    def gen_stmt(self, node):
        a = self.asm
        if node is None:
            return
        if isinstance(node, c_ast.Compound):
            self.push_scope()
            for item in (node.block_items or []):
                self.gen_stmt(item)
            self.pop_scope()
        elif isinstance(node, c_ast.Decl):
            self.gen_local_decl(node)
        elif isinstance(node, c_ast.DeclList):
            for d in node.decls:
                self.gen_local_decl(d)
        elif isinstance(node, c_ast.Typedef):
            self.typedefs[node.name] = self.type_of_decl(node.type)
        elif isinstance(node, c_ast.Return):
            if node.expr is not None:
                t = self.gen_expr(node.expr)
                r = self.reg_of(t)
                if r != "a0":
                    a.mv("a0", r)
                self.free(t)
            self.gen_return()
        elif isinstance(node, c_ast.If):
            els = self.lbl("else")
            end = self.lbl("endif")
            self.gen_cond_branch(node.cond, false_label=els)
            self.gen_stmt(node.iftrue)
            if node.iffalse is not None:
                a.j(end)
                a.label(els)
                self.gen_stmt(node.iffalse)
                a.label(end)
            else:
                a.label(els)
        elif isinstance(node, c_ast.While):
            top = self.lbl("wtop")
            end = self.lbl("wend")
            a.label(top)
            self.gen_cond_branch(node.cond, false_label=end)
            self.break_stack.append(end)
            self.cont_stack.append(top)
            self.gen_stmt(node.stmt)
            self.break_stack.pop()
            self.cont_stack.pop()
            a.j(top)
            a.label(end)
        elif isinstance(node, c_ast.DoWhile):
            top = self.lbl("dtop")
            cont = self.lbl("dcont")
            end = self.lbl("dend")
            a.label(top)
            self.break_stack.append(end)
            self.cont_stack.append(cont)
            self.gen_stmt(node.stmt)
            self.break_stack.pop()
            self.cont_stack.pop()
            a.label(cont)
            self.gen_cond_branch(node.cond, true_label=top)
            a.label(end)
        elif isinstance(node, c_ast.For):
            self.push_scope()
            if node.init is not None:
                if isinstance(node.init, (c_ast.Decl, c_ast.DeclList)):
                    self.gen_stmt(node.init)
                else:
                    self.gen_expr_discard(node.init)
            top = self.lbl("ftop")
            cont = self.lbl("fcont")
            end = self.lbl("fend")
            a.label(top)
            if node.cond is not None:
                self.gen_cond_branch(node.cond, false_label=end)
            self.break_stack.append(end)
            self.cont_stack.append(cont)
            self.gen_stmt(node.stmt)
            self.break_stack.pop()
            self.cont_stack.pop()
            a.label(cont)
            if node.next is not None:
                self.gen_expr_discard(node.next)
            a.j(top)
            a.label(end)
            self.pop_scope()
        elif isinstance(node, c_ast.Break):
            a.j(self.break_stack[-1])
        elif isinstance(node, c_ast.Continue):
            a.j(self.cont_stack[-1])
        elif isinstance(node, c_ast.Switch):
            self.gen_switch(node)
        elif isinstance(node, c_ast.Label):
            a.label(f"{self.func_name}.{node.name}")
            self.gen_stmt(node.stmt)
        elif isinstance(node, c_ast.Goto):
            a.j(f"{self.func_name}.{node.name}")
        elif isinstance(node, (c_ast.EmptyStatement, c_ast.Pragma)):
            pass
        else:
            self.gen_expr_discard(node)

    # -- declarations ----------------------------------------------------------

    def gen_local_decl(self, decl):
        t = self.type_of_decl(decl.type)
        if t.is_func():
            self.globals.setdefault(decl.name, Var("func", t, sym=decl.name))
            return
        if decl.name is None:
            return
        if "static" in (decl.storage or []):
            gname = f"{self.func_name}__{decl.name}"
            t = self._complete_array(t, decl.init)
            v = self.emit_global(gname, t, decl.init)
            del self.globals[gname]
            self.locals_scopes[-1][decl.name] = v
            return
        t = self._complete_array(t, decl.init)
        if t.is_arr() and t.size > 512:
            raise CompileError(
                f"{decl.name}: large local array ({t.size}B); frames are "
                "small — make it global/static or heap-allocate")
        v = self.declare_local(decl.name, t)
        if decl.init is not None:
            self.gen_local_init(v, t, decl.init)

    def gen_local_init(self, v, t, init):
        a = self.asm
        if isinstance(init, c_ast.InitList):
            # pins never persist across gen_expr recursion: materialize
            # addr/value pairwise per element
            addr = self.new_tmp(PtrT(U8))
            self.frame_addr(self.reg_of(addr), v.off)
            self.gen_memclear(addr, (t.size + 3) & ~3)
            addr.pinned = False
            elems = []
            if t.is_arr():
                elems = [(i * t.elem.size, t.elem, e)
                         for i, e in enumerate(init.exprs)]
            elif t.is_struct():
                elems = [(foff, ftp, e) for (fname, (foff, ftp)), e
                         in zip(t.fields.items(), init.exprs)]
            else:
                elems = [(0, t, init.exprs[0])]
            for off, ftp, e in elems:
                if isinstance(e, c_ast.InitList):
                    raise CompileError("nested local init lists unsupported")
                et = self.gen_expr(e)
                re_ = self.reg_of(et, pin=True)
                ra = self.reg_of(addr, pin=True)
                self.gen_store_at(ra, off, re_, ftp)
                et.pinned = addr.pinned = False
                self.free(et)
            self.free(addr)
            return
        if (t.is_arr() and t.elem.size == 1
                and isinstance(init, c_ast.Constant)
                and init.type == "string"):
            sym = self.string_lit(init)
            dst = self.new_tmp(PtrT(U8))
            self.frame_addr(self.reg_of(dst, pin=True), v.off)
            src = self.new_tmp(PtrT(U8))
            self.la(self.reg_of(src, pin=True), sym)
            self.gen_memcpy(dst, src, (t.size + 3) & ~3)
            return
        if t.is_struct():
            src = self.gen_expr_addr(init)
            dst = self.new_tmp(PtrT(U8))
            self.reg_of(src, pin=True)
            self.frame_addr(self.reg_of(dst, pin=True), v.off)
            self.gen_memcpy(dst, src, t.size)
            return
        et = self.gen_expr(init)
        r = self.reg_of(et, pin=True)
        if t.size == 4 or t.is_ptr():
            self.store_frame(r, v.off)
        else:
            tmpa = self.new_tmp(PtrT(U8))
            self.frame_addr(self.reg_of(tmpa), v.off)
            self.gen_store_at(self.reg_of(tmpa), 0, r, t)
            self.free(tmpa)
        self.free(et)

    def gen_memclear(self, addr_tmp, size):
        """Zero size bytes at addr_tmp; does NOT consume addr_tmp."""
        a = self.asm
        if size <= 64 and size % 4 == 0:
            r = self.reg_of(addr_tmp, pin=True)
            for off in range(0, size, 4):
                a.sw("zero", r, off)
            addr_tmp.pinned = False
            return
        ra = self.reg_of(addr_tmp, pin=True)
        dup = self.new_tmp(addr_tmp.type)
        a.mv(self.reg_of(dup), ra)
        addr_tmp.pinned = False
        self.call_symbol("memset",
                         [dup, self.const_tmp(0), self.const_tmp(size)])

    def gen_memcpy(self, dst, src, size):
        """Copy size bytes; consumes dst/src temps."""
        a = self.asm
        if size <= 64 and size % 4 == 0:
            rd = self.reg_of(dst, pin=True)
            rs = self.reg_of(src, pin=True)
            scratch = self.new_tmp(U32)
            rt = self.reg_of(scratch)
            for off in range(0, size, 4):
                a.lw(rt, rs, off)
                a.sw(rt, rd, off)
            self.free(scratch)
            self.free(dst)
            self.free(src)
            return
        self.call_symbol("memcpy", [dst, src, self.const_tmp(size)])

    def const_tmp(self, val, ctype=U32):
        t = self.new_tmp(ctype)
        self.asm.li(self.reg_of(t), val & 0xFFFFFFFF)
        return t

    def call_symbol(self, name, arg_tmps):
        """Call a named function with already-evaluated Tmp args;
        frees the args; result is ignored."""
        self.needed_funcs.add(name)
        a = self.asm
        for t in self.live:
            if t not in arg_tmps and t.reg is not None:
                t.pinned = False
                t.slot = self.alloc_slot()
                self.store_frame(t.reg, t.slot)
                self.free_regs.insert(0, t.reg)
                t.reg = None
        for i, t in enumerate(arg_tmps):
            if t.reg is not None:
                a.mv(ARG_REGS[i], t.reg)
            else:
                self.load_frame(ARG_REGS[i], t.slot)
        for t in arg_tmps:
            self.free(t)
        a.jal("ra", name)

    # -- switch ------------------------------------------------------------

    def gen_switch(self, node):
        a = self.asm
        self.spill_all()
        vt = self.gen_expr(node.cond)
        ct = self.expr_type(node.cond)
        signed = ct.is_int() and ct.signed
        end = self.lbl("swend")

        if isinstance(node.stmt, c_ast.Compound):
            body_items = node.stmt.block_items or []
        else:
            body_items = [node.stmt]

        cases = []
        default_lbl = None
        labeled = []

        def collect(st):
            nonlocal default_lbl
            while isinstance(st, (c_ast.Case, c_ast.Default)):
                if isinstance(st, c_ast.Case):
                    lb = self.lbl("case")
                    cases.append((self.const_expr(st.expr), lb))
                    labeled.append(("label", lb))
                else:
                    default_lbl = self.lbl("default")
                    labeled.append(("label", default_lbl))
                sts = st.stmts or []
                if not sts:
                    return
                for s in sts[:-1]:
                    labeled.append(("stmt", s))
                st = sts[-1]
            labeled.append(("stmt", st))

        for st in body_items:
            collect(st)

        r = self.reg_of(vt, pin=True)
        cases_sorted = sorted(cases)
        miss = default_lbl or end

        def tree(lo, hi):
            if hi - lo <= 4:
                for v, lb in cases_sorted[lo:hi]:
                    cmp_t = self.const_tmp(v)
                    self.cbr("beq", r, self.reg_of(cmp_t), lb)
                    self.free(cmp_t)
                a.j(miss)
                return
            mid = (lo + hi) // 2
            pivot, plb = cases_sorted[mid]
            cmp_t = self.const_tmp(pivot)
            rc = self.reg_of(cmp_t)
            self.cbr("beq", r, rc, plb)
            right = self.lbl("swr")
            self.cbr("blt" if signed else "bltu", rc, r, right)
            self.free(cmp_t)
            tree(lo, mid)
            a.label(right)
            tree(mid + 1, hi)

        tree(0, len(cases_sorted))
        self.free(vt)

        self.break_stack.append(end)
        for kind, x in labeled:
            if kind == "label":
                a.label(x)
            else:
                self.gen_stmt(x)
        self.break_stack.pop()
        a.label(end)

    # -- conditions ------------------------------------------------------------

    def gen_cond_branch(self, cond, true_label=None, false_label=None):
        """Branch on a condition (exactly one target; fallthrough
        otherwise). Spills all outer temps first so both runtime paths
        agree on canonical temp locations."""
        a = self.asm
        self.spill_all()
        if isinstance(cond, c_ast.BinaryOp) and cond.op in (
                "==", "!=", "<", ">", "<=", ">="):
            lt = self.expr_type(cond.left)
            rt = self.expr_type(cond.right)
            signed = (lt.is_int() and lt.signed
                      and rt.is_int() and rt.signed)
            tl = self.gen_expr(cond.left)
            tr = self.gen_expr(cond.right)
            rl = self.reg_of(tl, pin=True)
            rr = self.reg_of(tr, pin=True)
            op = cond.op
            if false_label is not None:
                op = {"==": "!=", "!=": "==", "<": ">=", ">=": "<",
                      ">": "<=", "<=": ">"}[op]
                target = false_label
            else:
                target = true_label
            bl, bg = ("blt", "bge") if signed else ("bltu", "bgeu")
            if op == "==":
                self.cbr("beq", rl, rr, target)
            elif op == "!=":
                self.cbr("bne", rl, rr, target)
            elif op == "<":
                self.cbr(bl, rl, rr, target)
            elif op == ">=":
                self.cbr(bg, rl, rr, target)
            elif op == ">":
                self.cbr(bl, rr, rl, target)
            elif op == "<=":
                self.cbr(bg, rr, rl, target)
            self.free(tl)
            self.free(tr)
            return
        if isinstance(cond, c_ast.BinaryOp) and cond.op == "&&":
            if false_label is not None:
                self.gen_cond_branch(cond.left, false_label=false_label)
                self.gen_cond_branch(cond.right, false_label=false_label)
            else:
                skip = self.lbl("andskip")
                self.gen_cond_branch(cond.left, false_label=skip)
                self.gen_cond_branch(cond.right, true_label=true_label)
                a.label(skip)
            return
        if isinstance(cond, c_ast.BinaryOp) and cond.op == "||":
            if true_label is not None:
                self.gen_cond_branch(cond.left, true_label=true_label)
                self.gen_cond_branch(cond.right, true_label=true_label)
            else:
                ok = self.lbl("orok")
                self.gen_cond_branch(cond.left, true_label=ok)
                self.gen_cond_branch(cond.right, false_label=false_label)
                a.label(ok)
            return
        if isinstance(cond, c_ast.UnaryOp) and cond.op == "!":
            self.gen_cond_branch(cond.expr, true_label=false_label,
                                 false_label=true_label)
            return
        t = self.gen_expr(cond)
        r = self.reg_of(t)
        if false_label is not None:
            self.cbr("beq", r, "zero", false_label)
        else:
            self.cbr("bne", r, "zero", true_label)
        self.free(t)

    # -- expressions -----------------------------------------------------------

    def gen_expr_discard(self, node):
        t = self.gen_expr(node, want_value=False)
        if t is not None:
            self.free(t)

    def gen_expr(self, node, want_value=True):
        a = self.asm
        cv = self._fold(node)
        if cv is not None:
            t = self.new_tmp(self.expr_type(node))
            a.li(self.reg_of(t), cv)
            return t

        if isinstance(node, c_ast.Constant):
            if node.type == "string":
                sym = self.string_lit(node)
                t = self.new_tmp(PtrT(I8))
                self.la(self.reg_of(t), sym)
                return t
            t = self.new_tmp(I32)
            a.li(self.reg_of(t), self.const_expr(node))
            return t

        if isinstance(node, c_ast.ID):
            v = self.lookup(node.name)
            if v.kind == "enum":
                t = self.new_tmp(I32)
                a.li(self.reg_of(t), v.value)
                return t
            if v.kind == "func":
                t = self.new_tmp(PtrT(v.type))
                self.la(self.reg_of(t), v.sym)
                self.needed_funcs.add(v.sym)
                return t
            if v.type.is_arr():
                t = self.new_tmp(PtrT(v.type.elem))
                if v.kind == "local":
                    self.frame_addr(self.reg_of(t), v.off)
                else:
                    self.la(self.reg_of(t), v.sym)
                return t
            if v.type.is_struct():
                t = self.new_tmp(PtrT(v.type))
                if v.kind == "local":
                    self.frame_addr(self.reg_of(t), v.off)
                else:
                    self.la(self.reg_of(t), v.sym)
                return t
            t = self.new_tmp(v.type)
            r = self.reg_of(t)
            if v.kind == "local":
                if v.type.size == 4 or v.type.is_ptr():
                    self.load_frame(r, v.off)
                else:
                    self.frame_addr(r, v.off)
                    self.gen_load_at(r, 0, r, v.type)
            else:
                self.la(r, v.sym)
                self.gen_load_at(r, 0, r, v.type)
            return t

        if isinstance(node, c_ast.ExprList):
            for e in node.exprs[:-1]:
                self.gen_expr_discard(e)
            return self.gen_expr(node.exprs[-1])

        if isinstance(node, c_ast.Cast):
            to = self.type_of_decl(node.to_type)
            t = self.gen_expr(node.expr)
            if to.is_void():
                self.free(t)
                return self.const_tmp(0, U32)
            src = t.type
            t.type = to
            if to.is_int() and to.size < 4:
                if not (src.is_int() and src.size == to.size
                        and src.signed == to.signed):
                    self.gen_truncate(self.reg_of(t), to)
            return t

        if isinstance(node, c_ast.UnaryOp):
            return self.gen_unary(node)
        if isinstance(node, c_ast.BinaryOp):
            return self.gen_binop(node)

        if isinstance(node, c_ast.TernaryOp):
            res = self.slot_tmp(self.expr_type(node))
            els = self.lbl("terne")
            end = self.lbl("ternx")
            self.gen_cond_branch(node.cond, false_label=els)
            tv = self.gen_expr(node.iftrue)
            self.store_frame(self.reg_of(tv), res.slot)
            self.free(tv)
            a.j(end)
            a.label(els)
            fv = self.gen_expr(node.iffalse)
            self.store_frame(self.reg_of(fv), res.slot)
            self.free(fv)
            a.label(end)
            return res

        if isinstance(node, c_ast.Assignment):
            return self.gen_assign(node, want_value)
        if isinstance(node, c_ast.FuncCall):
            return self.gen_call(node)

        if isinstance(node, (c_ast.ArrayRef, c_ast.StructRef)):
            addr = self.gen_expr_addr(node)
            t = self.expr_type(node)
            if t.is_arr():
                addr.type = PtrT(t.elem)
                return addr
            if t.is_struct():
                addr.type = PtrT(t)
                return addr
            r = self.reg_of(addr)
            self.gen_load_at(r, 0, r, t)
            addr.type = t
            return addr

        raise CompileError(f"unhandled expr {type(node).__name__}")

    def gen_truncate(self, r, to):
        a = self.asm
        if to.size == 1:
            if to.signed:
                a.slli(r, r, 24)
                a.srai(r, r, 24)
            else:
                a.andi(r, r, 0xFF)
        elif to.size == 2:
            a.slli(r, r, 16)
            (a.srai if to.signed else a.srli)(r, r, 16)

    def gen_load_at(self, addr_reg, off, dst_reg, ctype):
        a = self.asm
        if not (-2048 <= off < 2048):
            a.li(dst_reg, off) if addr_reg != dst_reg else None
            if addr_reg == dst_reg:
                raise CompileError("large-offset load aliasing")
            a.add(dst_reg, addr_reg, dst_reg)
            addr_reg, off = dst_reg, 0
        if ctype.is_ptr() or ctype.size == 4:
            a.lw(dst_reg, addr_reg, off)
        elif ctype.size == 2:
            (a.lh if ctype.signed else a.lhu)(dst_reg, addr_reg, off)
        elif ctype.size == 1:
            (a.lb if ctype.signed else a.lbu)(dst_reg, addr_reg, off)
        else:
            raise CompileError(f"load of size {ctype.size}")

    def gen_store_at(self, addr_reg, off, val_reg, ctype):
        a = self.asm
        if not (-2048 <= off < 2048):
            sc = self.new_tmp(U32)
            rs = self.reg_of(sc)
            a.li(rs, off)
            a.add(rs, addr_reg, rs)
            addr_reg, off = rs, 0
            self.free(sc)
        if ctype.is_ptr() or ctype.size == 4:
            a.sw(val_reg, addr_reg, off)
        elif ctype.size == 2:
            a.sh(val_reg, addr_reg, off)
        elif ctype.size == 1:
            a.sb(val_reg, addr_reg, off)
        else:
            raise CompileError(f"store of size {ctype.size}")

    # -- lvalue addresses -------------------------------------------------------

    def _add_const(self, t, off):
        a = self.asm
        if not off:
            return
        r = self.reg_of(t)
        if -2048 <= off < 2048:
            a.addi(r, r, off)
        else:
            self.reg_of(t, pin=True)
            it = self.const_tmp(off)
            a.add(self.reg_of(t), self.reg_of(t), self.reg_of(it))
            self.free(it)
            t.pinned = False

    def _scale(self, t, size):
        """Multiply the int temp in-place by an element size."""
        a = self.asm
        if size == 1:
            return
        r = self.reg_of(t)
        if size & (size - 1) == 0:
            a.slli(r, r, size.bit_length() - 1)
        else:
            self.reg_of(t, pin=True)
            st = self.const_tmp(size)
            a.mul(self.reg_of(t), self.reg_of(t), self.reg_of(st))
            self.free(st)
            t.pinned = False

    def gen_expr_addr(self, node):
        a = self.asm
        if isinstance(node, c_ast.ID):
            v = self.lookup(node.name)
            t = self.new_tmp(PtrT(v.type))
            if v.kind == "local":
                self.frame_addr(self.reg_of(t), v.off)
            elif v.kind == "global":
                self.la(self.reg_of(t), v.sym)
            elif v.kind == "func":
                self.la(self.reg_of(t), v.sym)
                self.needed_funcs.add(v.sym)
            else:
                self.err(node, f"cannot take address of {node.name}")
            return t
        if isinstance(node, c_ast.UnaryOp) and node.op == "*":
            return self.gen_expr(node.expr)
        if isinstance(node, c_ast.ArrayRef):
            base_t = self.expr_type(node.name)
            elem = base_t.elem if base_t.is_arr() else base_t.to
            base = self.gen_expr(node.name)
            idx_c = self._fold(node.subscript)
            if idx_c is not None:
                off = idx_c * elem.size
                off = off - (1 << 32) if off & 0x80000000 else off
                self._add_const(base, off)
                base.type = PtrT(elem)
                return base
            idx = self.gen_expr(node.subscript)
            self._scale(idx, elem.size)
            ri = self.reg_of(idx, pin=True)
            rb = self.reg_of(base)
            a.add(rb, rb, ri)
            self.free(idx)
            base.type = PtrT(elem)
            return base
        if isinstance(node, c_ast.StructRef):
            if node.type == "->":
                base = self.gen_expr(node.name)
                st = base.type.to if base.type.is_ptr() else None
            else:
                base = self.gen_expr_addr(node.name)
                st = base.type.to
            if st is not None and st.is_arr():
                st = st.elem
            if st is None or not st.is_struct():
                self.err(node, f"member access on non-struct {st}")
            if node.field.name not in st.fields:
                self.err(node, f"no field {node.field.name} in {st}")
            foff, ft = st.fields[node.field.name]
            self._add_const(base, foff)
            base.type = PtrT(ft)
            return base
        if isinstance(node, c_ast.Cast):
            return self.gen_expr_addr(node.expr)
        raise CompileError(f"not an lvalue: {type(node).__name__}")

    # -- unary -------------------------------------------------------------------

    def gen_unary(self, node):
        a = self.asm
        op = node.op
        if op == "&":
            return self.gen_expr_addr(node.expr)
        if op == "*":
            t = self.gen_expr(node.expr)
            pt = t.type
            target = pt.to if pt.is_ptr() else pt.elem
            if target.is_struct():
                t.type = PtrT(target)
                return t
            if target.is_arr():
                t.type = PtrT(target.elem)
                return t
            r = self.reg_of(t)
            self.gen_load_at(r, 0, r, target)
            t.type = target
            return t
        if op in ("-", "+", "~", "!"):
            t = self.gen_expr(node.expr)
            r = self.reg_of(t)
            if op == "-":
                a.sub(r, "zero", r)
            elif op == "~":
                a.xori(r, r, -1)
            elif op == "!":
                a.sltiu(r, r, 1)
                t.type = I32
            return t
        if op in ("++", "--", "p++", "p--"):
            t = self.expr_type(node.expr)
            step = t.to.size if t.is_ptr() else 1
            delta = step if op in ("++", "p++") else -step
            addr = self.gen_expr_addr(node.expr)
            ra = self.reg_of(addr, pin=True)
            val = self.new_tmp(t)
            rv = self.reg_of(val, pin=True)
            self.gen_load_at(ra, 0, rv, t)
            upd = self.new_tmp(t)
            ru = self.reg_of(upd, pin=True)
            if -2048 <= delta < 2048:
                a.addi(ru, rv, delta)
            else:
                a.li(ru, delta & 0xFFFFFFFF)
                a.add(ru, rv, ru)
            if t.is_int() and t.size < 4:
                self.gen_truncate(ru, t)
            self.gen_store_at(ra, 0, ru, t)
            self.free(addr)
            if op in ("++", "--"):
                self.free(val)
                upd.pinned = False
                return upd
            self.free(upd)
            val.pinned = False
            return val
        raise CompileError(f"unary {op}")

    # -- binary ------------------------------------------------------------------

    _IMM_OPS = {"+": "addi", "&": "andi", "|": "ori", "^": "xori"}

    def gen_binop(self, node):
        a = self.asm
        op = node.op
        if op in ("&&", "||"):
            res = self.slot_tmp(I32)
            out_false = self.lbl("bfalse")
            out_end = self.lbl("bend")
            self.gen_cond_branch(node, false_label=out_false)
            z = self.new_tmp(I32)
            a.li(self.reg_of(z), 1)
            self.store_frame(self.reg_of(z), res.slot)
            a.j(out_end)
            a.label(out_false)
            a.li(self.reg_of(z), 0)
            self.store_frame(self.reg_of(z), res.slot)
            a.label(out_end)
            self.free(z)
            return res

        lt = self.expr_type(node.left)
        rt = self.expr_type(node.right)

        if op in ("==", "!=", "<", ">", "<=", ">="):
            signed = (lt.is_int() and lt.signed
                      and rt.is_int() and rt.signed)
            tl = self.gen_expr(node.left)
            tr = self.gen_expr(node.right)
            rl = self.reg_of(tl, pin=True)
            rr = self.reg_of(tr, pin=True)
            out = self.new_tmp(I32)
            ro = self.reg_of(out)
            slt = a.slt if signed else a.sltu
            if op == "==":
                a.sub(ro, rl, rr)
                a.sltiu(ro, ro, 1)
            elif op == "!=":
                a.sub(ro, rl, rr)
                a.sltu(ro, "zero", ro)
            elif op == "<":
                slt(ro, rl, rr)
            elif op == ">":
                slt(ro, rr, rl)
            elif op == "<=":
                slt(ro, rr, rl)
                a.xori(ro, ro, 1)
            elif op == ">=":
                slt(ro, rl, rr)
                a.xori(ro, ro, 1)
            self.free(tl)
            self.free(tr)
            return out

        l_ptr = lt.is_ptr() or lt.is_arr()
        r_ptr = rt.is_ptr() or rt.is_arr()
        if op == "+" and (l_ptr or r_ptr):
            pnode, inode = ((node.left, node.right) if l_ptr
                            else (node.right, node.left))
            pt = lt if l_ptr else rt
            elem = pt.elem if pt.is_arr() else pt.to
            p = self.gen_expr(pnode)
            ic = self._fold(inode)
            if ic is not None:
                off = ic * elem.size
                off = off - (1 << 32) if off & 0x80000000 else off
                self._add_const(p, off)
                p.type = PtrT(elem)
                return p
            i = self.gen_expr(inode)
            self._scale(i, elem.size)
            ri = self.reg_of(i, pin=True)
            rp = self.reg_of(p)
            a.add(rp, rp, ri)
            self.free(i)
            p.type = PtrT(elem)
            return p
        if op == "-" and l_ptr:
            elem = lt.elem if lt.is_arr() else lt.to
            p = self.gen_expr(node.left)
            if r_ptr:
                q = self.gen_expr(node.right)
                rq = self.reg_of(q, pin=True)
                rp = self.reg_of(p)
                a.sub(rp, rp, rq)
                self.free(q)
                if elem.size != 1:
                    if elem.size & (elem.size - 1) == 0:
                        a.srli(rp, rp, elem.size.bit_length() - 1)
                    else:
                        self.reg_of(p, pin=True)
                        st = self.const_tmp(elem.size)
                        a.divu(self.reg_of(p), self.reg_of(p),
                               self.reg_of(st))
                        self.free(st)
                        p.pinned = False
                p.type = I32
                return p
            i = self.gen_expr(node.right)
            self._scale(i, elem.size)
            ri = self.reg_of(i, pin=True)
            rp = self.reg_of(p)
            a.sub(rp, rp, ri)
            self.free(i)
            p.type = PtrT(elem)
            return p

        signed = (lt.is_int() and lt.signed and rt.is_int() and rt.signed)
        res_t = I32 if signed else U32

        rc = self._fold(node.right)
        if rc is not None and op in ("+", "-", "&", "|", "^", "<<", ">>"):
            tl = self.gen_expr(node.left)
            rl = self.reg_of(tl)
            sc = self._signed(rc)
            if op == "<<":
                a.slli(rl, rl, rc & 31)
            elif op == ">>":
                (a.srai if lt.is_int() and lt.signed else a.srli)(
                    rl, rl, rc & 31)
            elif op == "-" and -2048 <= -sc < 2048:
                a.addi(rl, rl, -sc)
            elif op in self._IMM_OPS and -2048 <= sc < 2048 and op != "-":
                getattr(a, self._IMM_OPS[op])(rl, rl, sc)
            else:
                self.reg_of(tl, pin=True)
                tr = self.const_tmp(rc)
                rr = self.reg_of(tr, pin=True)
                rl = self.reg_of(tl)
                self._emit_binop(op, rl, rl, rr, signed, lt)
                self.free(tr)
                tl.pinned = False
            tl.type = res_t
            return tl

        tl = self.gen_expr(node.left)
        tr = self.gen_expr(node.right)
        rl = self.reg_of(tl, pin=True)
        rr = self.reg_of(tr, pin=True)
        self._emit_binop(op, rl, rl, rr, signed, lt)
        self.free(tr)
        tl.pinned = False
        tl.type = res_t
        return tl

    @staticmethod
    def _signed(v):
        return v - (1 << 32) if v & 0x80000000 else v

    def _emit_binop(self, op, rd, rl, rr, signed, lt):
        a = self.asm
        if op == "+":
            a.add(rd, rl, rr)
        elif op == "-":
            a.sub(rd, rl, rr)
        elif op == "*":
            a.mul(rd, rl, rr)
        elif op == "/":
            (a.div if signed else a.divu)(rd, rl, rr)
        elif op == "%":
            (a.rem if signed else a.remu)(rd, rl, rr)
        elif op == "&":
            a.and_(rd, rl, rr)
        elif op == "|":
            a.or_(rd, rl, rr)
        elif op == "^":
            a.xor(rd, rl, rr)
        elif op == "<<":
            a.sll(rd, rl, rr)
        elif op == ">>":
            (a.sra if lt.is_int() and lt.signed else a.srl)(rd, rl, rr)
        else:
            raise CompileError(f"binop {op}")

    # -- assignment ---------------------------------------------------------

    def gen_assign(self, node, want_value):
        lt = self.expr_type(node.lvalue)
        if node.op == "=" and lt.is_struct():
            src = self.gen_expr(node.rvalue)     # struct rvalue == pointer
            dst = self.gen_expr_addr(node.lvalue)
            self.reg_of(src, pin=True)
            self.reg_of(dst, pin=True)
            self.gen_memcpy(dst, src, lt.size)
            return self.const_tmp(0) if want_value else None

        if node.op == "=":
            val = self.gen_expr(node.rvalue)
            addr = self.gen_expr_addr(node.lvalue)
            rv = self.reg_of(val, pin=True)
            ra = self.reg_of(addr, pin=True)
            self.gen_store_at(ra, 0, rv, lt)
            self.free(addr)
            val.pinned = False
            if want_value:
                val.type = lt
                return val
            self.free(val)
            return None

        binop = node.op[:-1]
        addr = self.gen_expr_addr(node.lvalue)
        cur = self.new_tmp(lt)
        ra = self.reg_of(addr, pin=True)
        rc = self.reg_of(cur, pin=True)
        self.gen_load_at(ra, 0, rc, lt)
        addr.pinned = cur.pinned = False
        val = self.gen_expr(node.rvalue)
        if lt.is_ptr() and binop in ("+", "-"):
            self._scale(val, lt.to.size)
            rv = self.reg_of(val, pin=True)
            rc = self.reg_of(cur, pin=True)
            (self.asm.add if binop == "+" else self.asm.sub)(rc, rc, rv)
            self.free(val)
        else:
            rv = self.reg_of(val, pin=True)
            rc = self.reg_of(cur, pin=True)
            rtt = self.expr_type(node.rvalue)
            signed = lt.signed and rtt.is_int() and rtt.signed
            self._emit_binop(binop, rc, rc, rv, signed, lt)
            if lt.is_int() and lt.size < 4:
                self.gen_truncate(rc, lt)
            self.free(val)
        ra = self.reg_of(addr, pin=True)
        self.gen_store_at(ra, 0, self.reg_of(cur), lt)
        self.free(addr)
        cur.pinned = False
        if want_value:
            return cur
        self.free(cur)
        return None

    # -- calls --------------------------------------------------------------

    _MUL_BUILTINS = {"__mulhu": "mulhu", "__mulh": "mulh",
                     "__mulhsu": "mulhsu"}

    def _gen_u256_carry_chain(self, node, is_add):
        """__u256_add/__u256_sub(r, a, b): unrolled 8-limb carry chain,
        ~7 instructions per limb, no frame traffic. Returns carry/borrow."""
        a = self.asm
        args = [self.gen_expr(e) for e in node.args.exprs]
        rr = self.reg_of(args[0], pin=True)
        ra = self.reg_of(args[1], pin=True)
        rb = self.reg_of(args[2], pin=True)
        x = self.new_tmp(U32)
        y = self.new_tmp(U32)
        s = self.new_tmp(U32)
        carry = self.new_tmp(U32)
        rx, ry, rs = self.reg_of(x, pin=True), self.reg_of(y, pin=True), \
            self.reg_of(s, pin=True)
        rc = self.reg_of(carry, pin=True)
        a.li(rc, 0)
        for i in range(8):
            a.lw(rx, ra, 4 * i)
            a.lw(ry, rb, 4 * i)
            if is_add:
                a.add(rs, rx, ry)        # s = x + y
                a.sltu(rx, rs, rx)       # c1 = s < x
                a.add(ry, rs, rc)        # t = s + carry
                a.sltu(rs, ry, rs)       # c2 = t < s
                a.or_(rc, rx, rs)
                a.sw(ry, rr, 4 * i)
            else:
                a.sub(rs, rx, ry)        # d = x - y
                a.sltu(rx, rx, ry)       # b1 = x < y
                a.sltu(ry, rs, rc)       # b2 = d < borrow
                a.sub(rs, rs, rc)        # t = d - borrow
                a.or_(rc, rx, ry)
                a.sw(rs, rr, 4 * i)
        for t in (args[0], args[1], args[2], x, y, s):
            self.free(t)
        carry.pinned = False
        carry.type = U32
        return carry

    def _gen_u256_lt(self, node):
        """__u256_lt(a, b) -> 1 if a < b (unsigned 256-bit), else 0."""
        a = self.asm
        args = [self.gen_expr(e) for e in node.args.exprs]
        ra = self.reg_of(args[0], pin=True)
        rb = self.reg_of(args[1], pin=True)
        x = self.new_tmp(U32)
        y = self.new_tmp(U32)
        out = self.new_tmp(U32)
        rx, ry = self.reg_of(x, pin=True), self.reg_of(y, pin=True)
        ro = self.reg_of(out, pin=True)
        done = self.lbl("u256lt")
        a.li(ro, 0)
        for i in range(7, -1, -1):
            a.lw(rx, ra, 4 * i)
            a.lw(ry, rb, 4 * i)
            a.sltu(ro, rx, ry)           # a < b at this limb
            self.cbr("bne", rx, ry, done)
        a.label(done)
        for t in (args[0], args[1], x, y):
            self.free(t)
        out.pinned = False
        return out

    def _gen_inline_memcpy(self, node, n):
        """Constant-size word-aligned-checked memcpy: unrolled word copy
        behind a runtime alignment test, byte loop otherwise."""
        a = self.asm
        dst = self.gen_expr(node.args.exprs[0])
        src = self.gen_expr(node.args.exprs[1])
        rd = self.reg_of(dst, pin=True)
        rs = self.reg_of(src, pin=True)
        t = self.new_tmp(U32)
        rt = self.reg_of(t, pin=True)
        bytelbl = self.lbl("mcpyb")
        end = self.lbl("mcpye")
        a.or_(rt, rd, rs)
        a.andi(rt, rt, 3)
        self.cbr("bne", rt, "zero", bytelbl)
        for off in range(0, n, 4):
            a.lw(rt, rs, off)
            a.sw(rt, rd, off)
        a.j(end)
        a.label(bytelbl)
        for off in range(n):
            a.lb(rt, rs, off)
            a.sb(rt, rd, off)
        a.label(end)
        self.free(t)
        self.free(src)
        dst.pinned = False
        dst.type = PtrT(U8)
        return dst

    def gen_call(self, node):
        a = self.asm
        if isinstance(node.name, c_ast.ID) and node.name.name == "__ecall":
            return self.gen_ecall(node)
        if isinstance(node.name, c_ast.ID) and \
                node.name.name in ("__u256_add", "__u256_sub"):
            return self._gen_u256_carry_chain(
                node, node.name.name == "__u256_add")
        if isinstance(node.name, c_ast.ID) and node.name.name == "__u256_lt":
            return self._gen_u256_lt(node)
        if isinstance(node.name, c_ast.ID) and node.name.name == "memcpy" \
                and node.args and len(node.args.exprs) == 3:
            nconst = self._fold(node.args.exprs[2])
            if nconst is not None and 0 < nconst <= 96 and nconst % 4 == 0:
                return self._gen_inline_memcpy(node, nconst)
        if isinstance(node.name, c_ast.ID) and \
                node.name.name in self._MUL_BUILTINS:
            insn = self._MUL_BUILTINS[node.name.name]
            tl = self.gen_expr(node.args.exprs[0])
            tr = self.gen_expr(node.args.exprs[1])
            rl = self.reg_of(tl, pin=True)
            rr = self.reg_of(tr, pin=True)
            getattr(a, insn)(rl, rl, rr)
            self.free(tr)
            tl.pinned = False
            tl.type = U32 if insn == "mulhu" else I32
            return tl

        fp = None
        if isinstance(node.name, c_ast.ID):
            v = self.globals.get(node.name.name)
            if v is not None and v.kind == "func":
                ft = v.type
                self.needed_funcs.add(node.name.name)
            elif v is None and not any(
                    node.name.name in sc for sc in self.locals_scopes):
                raise CompileError(f"call to undeclared {node.name.name}")
            else:
                fp = self.gen_expr(node.name)
                ft = fp.type.to if fp.type.is_ptr() else fp.type
        else:
            fp = self.gen_expr(node.name)
            ft = fp.type.to if fp.type.is_ptr() else fp.type
        args = node.args.exprs if node.args else []
        if len(args) > 8:
            raise CompileError("more than 8 call arguments")
        arg_tmps = []
        for e in args:
            et = self.expr_type(e)
            if et.is_struct():
                raise CompileError("struct-by-value argument unsupported")
            arg_tmps.append(self.gen_expr(e))
        for t in self.live:
            if t not in arg_tmps and t is not fp and t.reg is not None:
                t.pinned = False
                t.slot = self.alloc_slot()
                self.store_frame(t.reg, t.slot)
                self.free_regs.insert(0, t.reg)
                t.reg = None
        for i, t in enumerate(arg_tmps):
            if t.reg is not None:
                a.mv(ARG_REGS[i], t.reg)
            else:
                self.load_frame(ARG_REGS[i], t.slot)
        for t in arg_tmps:
            self.free(t)
        if fp is None:
            a.jal("ra", node.name.name)
        else:
            a.jalr("ra", self.reg_of(fp), 0)
            self.free(fp)
        ret = self.new_tmp(ft.ret if not ft.ret.is_void() else U32)
        r = self.reg_of(ret)
        if r != "a0":
            a.mv(r, "a0")
        return ret

    def gen_ecall(self, node):
        """__ecall(num, a0, a1) -> post-call a0 (the zkVM syscall)."""
        a = self.asm
        args = node.args.exprs
        if len(args) != 3:
            raise CompileError("__ecall takes (num, arg0, arg1)")
        tmps = [self.gen_expr(e) for e in args]
        for t in self.live:
            if t not in tmps and t.reg is not None:
                t.pinned = False
                t.slot = self.alloc_slot()
                self.store_frame(t.reg, t.slot)
                self.free_regs.insert(0, t.reg)
                t.reg = None
        regs = ["a7", "a0", "a1"]
        for i, t in enumerate(tmps):
            if t.reg is not None:
                a.mv(regs[i], t.reg)
            else:
                self.load_frame(regs[i], t.slot)
        for t in tmps:
            self.free(t)
        a.ecall()
        ret = self.new_tmp(U32)
        r = self.reg_of(ret)
        if r != "a0":
            a.mv(r, "a0")
        return ret


# ---------------------------------------------------------------------------
# compile pipeline
# ---------------------------------------------------------------------------

_INCLUDE_DIR = os.path.join(os.path.dirname(__file__), "include")


def preprocess(path, include_dirs=(), defines=()) -> str:
    cmd = ["gcc", "-E", "-std=c99", "-nostdinc", "-undef",
           "-D__GUEST__", "-I", _INCLUDE_DIR]
    for d in include_dirs:
        cmd += ["-I", str(d)]
    for d in defines:
        cmd += [f"-D{d}"]
    cmd.append(str(path))
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise CompileError(f"preprocess failed:\n{r.stderr}")
    return r.stdout


def compile_c(sources, include_dirs=(), defines=(), org=0x10000,
              stack_top=0x0400_0000, want_symbols=False):
    """Compile C sources (paths or inline code strings) to an RV32IM ELF.

    With want_symbols=True returns (elf, {function_name: address}) — the
    profiler's symbolization table."""
    asts = []
    for src in sources:
        s = str(src)
        if "\n" in s or not os.path.exists(s):
            with tempfile.NamedTemporaryFile(
                    "w", suffix=".c", delete=False) as f:
                f.write(s)
                tmp = f.name
            try:
                text = preprocess(tmp, include_dirs, defines)
            finally:
                os.unlink(tmp)
        else:
            text = preprocess(s, include_dirs, defines)
        asts.append(c_parser.CParser().parse(text, s[:40]))
    comp = Compiler(org=org, stack_top=stack_top)
    elf = comp.compile(asts)
    if want_symbols:
        syms = {name: comp.asm.labels[name]
                for name in comp.emitted_funcs if name in comp.asm.labels}
        return elf, syms
    return elf
