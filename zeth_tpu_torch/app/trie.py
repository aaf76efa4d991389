"""Sparse Merkle-Patricia trie over keccak-256.

Replaces risc0-ethereum-trie + the SparseState machinery of zeth-core
(SURVEY.md §2.1: `RlpTrie`, `SparseState::new/account/storage/
calculate_state_root`, crates/core/src/lib.rs:56-240): rebuilds a trie
from prehashed witness RLP nodes, serves lookups, applies post-state
updates (inserts before removals), and recomputes the root.

Nodes: None (empty) | Leaf | Extension | Branch | Digest (unresolved
hash reference — traversing into one raises MissingNode, the signal that
the witness was insufficient).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..hash.keccak import keccak256
from . import rlp

EMPTY_ROOT = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421")


class MissingNode(Exception):
    """Lookup/update hit an unresolved digest node.

    Carries the digest (hex) and, where known, the nibble-path prefix of
    the unresolved node from the trie root — the signal preflight's
    orphan recovery needs to hunt a key preimage under that prefix
    (the reference's orphan::Error::Unresolvable, trie.rs:120-137).
    `address` is annotated by SparseState when the trie is a storage trie.
    """

    def __init__(self, digest_hex: str, prefix: tuple | None = None):
        super().__init__(digest_hex)
        self.digest_hex = digest_hex
        self.prefix = prefix
        self.address: bytes | None = None


@dataclass
class Leaf:
    path: tuple      # remaining key nibbles
    value: bytes


@dataclass
class Extension:
    path: tuple
    child: object


@dataclass
class Branch:
    children: list   # 16 entries
    value: bytes     # branch value (unused by ethereum state tries)


@dataclass
class Digest:
    digest: bytes


def nibbles(key: bytes) -> tuple:
    out = []
    for b in key:
        out.append(b >> 4)
        out.append(b & 0xF)
    return tuple(out)


def hex_prefix(path: tuple, leaf: bool) -> bytes:
    flag = 2 if leaf else 0
    if len(path) % 2:
        data = [(flag + 1) << 4 | path[0]]
        rest = path[1:]
    else:
        data = [flag << 4]
        rest = path
    for i in range(0, len(rest), 2):
        data.append(rest[i] << 4 | rest[i + 1])
    return bytes(data)


def decode_hex_prefix(data: bytes) -> tuple[tuple, bool]:
    flag = data[0] >> 4
    leaf = bool(flag & 2)
    path = []
    if flag & 1:
        path.append(data[0] & 0xF)
    for b in data[1:]:
        path.append(b >> 4)
        path.append(b & 0xF)
    return tuple(path), leaf


class Trie:
    def __init__(self, root=None):
        self.root = root

    # -- construction from witness nodes ---------------------------------

    @classmethod
    def from_rlp_nodes(cls, nodes: list[bytes], root_hash: bytes) -> "Trie":
        """Rebuild the sparse trie reachable from root_hash.

        Mirrors SparseState::new (crates/core/src/lib.rs:135-155): keccak
        every witness node, then link children by digest; unresolved
        references stay Digest nodes.
        """
        by_digest = {keccak256(n): n for n in nodes}
        if root_hash == EMPTY_ROOT:
            return cls(None)
        return cls(cls._link(root_hash, by_digest))

    @classmethod
    def _link(cls, ref, by_digest):
        """ref: 32-byte digest or decoded RLP item (inline node)."""
        if isinstance(ref, (bytes, bytearray)):
            ref = bytes(ref)
            if len(ref) == 0:
                return None
            if len(ref) == 32:
                raw = by_digest.get(ref)
                if raw is None:
                    return Digest(ref)
                return cls._from_items(rlp.decode_full(raw), by_digest)
            raise ValueError("bad node reference")
        return cls._from_items(ref, by_digest)

    @classmethod
    def _from_items(cls, items, by_digest):
        if items == b"" or items is None:
            return None
        if len(items) == 17:
            children = [cls._link(c, by_digest) if c != b"" else None
                        for c in items[:16]]
            return Branch(children, bytes(items[16]))
        if len(items) == 2:
            path, leaf = decode_hex_prefix(bytes(items[0]))
            if leaf:
                return Leaf(path, bytes(items[1]))
            return Extension(path, cls._link(items[1], by_digest))
        raise ValueError("malformed trie node")

    # -- hashing ----------------------------------------------------------

    def root_hash(self) -> bytes:
        if self.root is None:
            return EMPTY_ROOT
        if isinstance(self.root, Digest):
            return self.root.digest
        return keccak256(_encode(self.root))

    # -- lookup ------------------------------------------------------------

    def get(self, key: bytes):
        return _get(self.root, nibbles(key))

    # -- update ------------------------------------------------------------

    def insert(self, key: bytes, value: bytes) -> None:
        self.root = _insert(self.root, nibbles(key), value)

    def delete(self, key: bytes) -> None:
        self.root = _delete(self.root, nibbles(key))

    # -- witness export ----------------------------------------------------

    def rlp_nodes(self) -> list[bytes]:
        """All resolved nodes, outermost first (witness serialization)."""
        out = []
        _collect(self.root, out)
        return out

    def proof_nodes(self, key: bytes) -> list[bytes]:
        """Minimal eth_getProof-style path proof: the hash-referenced
        nodes walked from the root toward `key`, root first."""
        out: list[bytes] = []
        node, path = self.root, nibbles(key)
        while node is not None and not isinstance(node, Digest):
            enc = _encode(node)
            if len(enc) >= 32:
                out.append(enc)
            if isinstance(node, Leaf):
                break
            if isinstance(node, Extension):
                k = len(node.path)
                if tuple(path[:k]) != node.path:
                    break
                node, path = node.child, path[k:]
            else:                       # Branch
                if not path:
                    break
                node, path = node.children[path[0]], path[1:]
        return out


def _get(node, path, pre=()):
    while True:
        if node is None:
            return None
        if isinstance(node, Digest):
            raise MissingNode(node.digest.hex(), pre)
        if isinstance(node, Leaf):
            return node.value if node.path == path else None
        if isinstance(node, Extension):
            k = len(node.path)
            if path[:k] != node.path:
                return None
            node, path, pre = node.child, path[k:], pre + node.path
            continue
        # Branch
        if not path:
            return node.value or None
        node, path, pre = node.children[path[0]], path[1:], pre + (path[0],)


def _encode(node) -> bytes:
    """RLP encoding of a node (digest refs for large children)."""
    if node is None:
        return rlp.encode(b"")
    if isinstance(node, Digest):
        return node.digest
    if isinstance(node, Leaf):
        return rlp.encode([hex_prefix(node.path, True), node.value])
    if isinstance(node, Extension):
        return rlp.encode([hex_prefix(node.path, False), _ref(node.child)])
    items = [_ref(c) if c is not None else b"" for c in node.children]
    items.append(node.value)
    return rlp.encode(items)


def _ref(node):
    """Child reference: inline if encoding < 32 bytes, else keccak digest."""
    if isinstance(node, Digest):
        return node.digest
    enc = _encode(node)
    if len(enc) < 32:
        return rlp.decode_full(enc)   # embed the decoded structure
    return keccak256(enc)


def _insert(node, path, value, pre=()):
    if node is None:
        return Leaf(tuple(path), value)
    if isinstance(node, Digest):
        raise MissingNode(node.digest.hex(), pre)
    if isinstance(node, Leaf):
        if node.path == path:
            return Leaf(node.path, value)
        common = _common(node.path, path)
        branch = Branch([None] * 16, b"")
        _branch_put(branch, node.path[len(common):], node.value, leaf=True)
        _branch_put(branch, path[len(common):], value, leaf=True)
        if common:
            return Extension(tuple(common), branch)
        return branch
    if isinstance(node, Extension):
        k = len(node.path)
        if path[:k] == node.path:
            return Extension(node.path, _insert(node.child, path[k:], value,
                                                pre + node.path))
        common = _common(node.path, path)
        c = len(common)
        branch = Branch([None] * 16, b"")
        # existing extension tail
        tail = node.path[c:]
        sub = node.child if len(tail) == 1 else Extension(tail[1:], node.child)
        branch.children[tail[0]] = sub
        _branch_put(branch, path[c:], value, leaf=True)
        if common:
            return Extension(tuple(common), branch)
        return branch
    # Branch
    if not path:
        return Branch(node.children[:], value)
    ch = node.children[:]
    ch[path[0]] = _insert(node.children[path[0]], path[1:], value,
                          pre + (path[0],))
    return Branch(ch, node.value)


def _branch_put(branch, path, value, leaf):
    if not path:
        branch.value = value
        return
    branch.children[path[0]] = Leaf(tuple(path[1:]), value)


def _delete(node, path, pre=()):
    if node is None:
        return None
    if isinstance(node, Digest):
        raise MissingNode(node.digest.hex(), pre)
    if isinstance(node, Leaf):
        return None if node.path == path else node
    if isinstance(node, Extension):
        k = len(node.path)
        if path[:k] != node.path:
            return node
        child = _delete(node.child, path[k:], pre + node.path)
        return _normalize_extension(node.path, child)
    # Branch
    if not path:
        node = Branch(node.children[:], b"")
    else:
        ch = node.children[:]
        ch[path[0]] = _delete(node.children[path[0]], path[1:],
                              pre + (path[0],))
        node = Branch(ch, node.value)
    return _normalize_branch(node, pre)


def _normalize_extension(path, child):
    if child is None:
        return None
    if isinstance(child, Leaf):
        return Leaf(tuple(path) + child.path, child.value)
    if isinstance(child, Extension):
        return Extension(tuple(path) + child.path, child.child)
    return Extension(tuple(path), child)


def _normalize_branch(node, pre=()):
    live = [(i, c) for i, c in enumerate(node.children) if c is not None]
    if node.value:
        if not live:
            return Leaf((), node.value)
        return node
    if len(live) > 1:
        return node
    if not live:
        return None
    i, c = live[0]
    if isinstance(c, Digest):
        # cannot collapse through an unresolved node: the deletion
        # orphaned the sibling at prefix pre+(i,) (trie.rs:104-110)
        raise MissingNode(c.digest.hex(), pre + (i,))
    return _normalize_extension((i,), c)


def _common(a, b):
    out = []
    for x, y in zip(a, b):
        if x != y:
            break
        out.append(x)
    return tuple(out)


def _collect(node, out):
    if node is None or isinstance(node, Digest):
        return
    enc = _encode(node)
    if len(enc) >= 32:
        out.append(enc)
    if isinstance(node, Extension):
        _collect(node.child, out)
    elif isinstance(node, Branch):
        for c in node.children:
            _collect(c, out)
