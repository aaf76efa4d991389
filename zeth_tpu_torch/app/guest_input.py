"""Guest ELF build + input serialization for the stateless-client guest.

Copy of ``zeth_tpu.app.guest_input`` over the port's own compiler
(``zeth_tpu_torch.cc``), guest sources (``zeth_tpu_torch/guest``) and
executor tooling; tests/test_torch_evm_input.py holds the ELF and the
encoded input equal to the reference's byte for byte.

The host half of the in-zkVM block validation path (reference role:
`to_zkvm_input_bytes` + the guests build crate, crates/host/src/lib.rs:150-154
and guests/src/lib.rs): serializes a StatelessInput into the guest's
word-aligned binary format and compiles/caches the stateless-client ELF
(zeth_tpu_torch/guest/stateless) with zeth-cc.
"""

from __future__ import annotations

import hashlib
import os
import struct

_GUEST_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "guest")
_CC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cc")

GUEST_SOURCES = [
    os.path.join(_GUEST_DIR, "stateless", "main.c"),
    os.path.join(_GUEST_DIR, "stateless", "txs.c"),
    os.path.join(_GUEST_DIR, "stateless", "evm.c"),
    os.path.join(_GUEST_DIR, "stateless", "gstate.c"),
    os.path.join(_GUEST_DIR, "lib", "trie.c"),
    os.path.join(_GUEST_DIR, "lib", "rlp.c"),
    os.path.join(_GUEST_DIR, "lib", "u256.c"),
    os.path.join(_GUEST_DIR, "lib", "keccak.c"),
    os.path.join(_GUEST_DIR, "lib", "hashes.c"),
    os.path.join(_GUEST_DIR, "lib", "secp256k1.c"),
    os.path.join(_GUEST_DIR, "lib", "bn254.c"),
    os.path.join(_GUEST_DIR, "lib", "bls381.c"),
    os.path.join(_CC_DIR, "runtime", "lib.c"),
]

_elf_cache: dict[str, bytes] = {}


def _write_atomic(path: str, data: bytes) -> None:
    """Write through a temporary file, so that a concurrent process never
    reads a half-written header or ELF."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _write_kzg_setup_header() -> None:
    """Generate include/kzg_setup.h from the host-provisioned KZG
    trusted setup (app/kzg.py). The generated header is hashed into the
    guest source digest, so provisioning a (different) setup changes
    the image ID — a guest image is bound to its ceremony constant."""
    from . import kzg
    pt = kzg.setup_g2()
    path = os.path.join(_GUEST_DIR, "include", "kzg_setup.h")
    lines = ["/* GENERATED by zeth_tpu_torch/app/guest_input.py — the KZG",
             " * ceremony's [tau]_2 point (or unprovisioned stub). */",
             "#ifndef ZETH_KZG_SETUP_H", "#define ZETH_KZG_SETUP_H"]
    if pt is None:
        lines += ["#define KZG_SETUP_PROVISIONED 0",
                  "static const uint32_t KZG_SETUP_G2[48] = {0};"]
    else:
        limbs = []
        for v in (pt[0][0], pt[0][1], pt[1][0], pt[1][1]):
            limbs += [(int(v) >> (32 * i)) & 0xFFFFFFFF for i in range(12)]
        rows = [", ".join(f"0x{v:08X}" for v in limbs[i:i + 4])
                for i in range(0, 48, 4)]
        lines += ["#define KZG_SETUP_PROVISIONED 1",
                  "static const uint32_t KZG_SETUP_G2[48] = {",
                  "  " + ",\n  ".join(rows) + "};"]
    lines += ["#endif", ""]
    content = "\n".join(lines)
    try:
        with open(path) as f:
            if f.read() == content:
                return
    except FileNotFoundError:
        pass
    _write_atomic(path, content.encode())


def source_digest() -> str:
    _write_kzg_setup_header()
    h = hashlib.sha256()
    for p in GUEST_SOURCES:
        with open(p, "rb") as f:
            h.update(f.read())
    inc = os.path.join(_GUEST_DIR, "include")
    for name in sorted(os.listdir(inc)):
        with open(os.path.join(inc, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build_stateless_elf() -> bytes:
    """Compile (or fetch from cache) the stateless-client guest ELF."""
    key = source_digest()
    if key in _elf_cache:
        return _elf_cache[key]
    cache_dir = os.path.join(_GUEST_DIR, ".build")
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"stateless_{key[:16]}.elf")
    if os.path.exists(path):
        with open(path, "rb") as f:
            elf = f.read()
    else:
        from ..cc import compile_c
        elf = compile_c(GUEST_SOURCES,
                        include_dirs=[os.path.join(_GUEST_DIR, "include")])
        _write_atomic(path, elf)
    _elf_cache[key] = elf
    return elf


def _pad4(b: bytes) -> bytes:
    return b + b"\x00" * (-len(b) % 4)


def _blob(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + _pad4(b)


def encode_guest_input(inp, chain_id: int) -> bytes:
    """StatelessInput -> the guest's binary input stream (main.c format)."""
    from . import txs as txs_mod
    from .host import _get_field, _to_bytes, _to_int

    out = struct.pack("<I", chain_id)
    out += _blob(inp.block.encode())
    out += struct.pack("<I", len(inp.witness.headers))
    for raw in inp.witness.headers:
        out += _blob(raw)
    txs = [txs_mod.Tx.from_json(t) for t in inp.transactions]
    out += struct.pack("<I", len(txs))
    for t in txs:
        out += _blob(t.encode())
    wds = inp.withdrawals or []
    out += struct.pack("<I", len(wds))
    for w in wds:
        addr = _to_bytes(_get_field(w, "address") or "0x")
        amount = _to_int(_get_field(w, "amount") or 0)
        out += addr.rjust(20, b"\x00") + amount.to_bytes(12, "big")
    out += struct.pack("<I", len(inp.witness.state))
    for n in inp.witness.state:
        out += _blob(n)
    out += struct.pack("<I", len(inp.witness.codes))
    for c in inp.witness.codes:
        out += _blob(c)
    return struct.pack("<I", len(out)) + _pad4(out)
