"""Sparse Ethereum state: state trie + per-account storage tries.

Replaces zeth-core's SparseState / StatelessTrie implementation
(SURVEY.md §2.1, crates/core/src/lib.rs:94-240): rebuild from an
execution witness, serve account/storage reads, apply a post-state
update set (inserts before removals, per the reference's orphan-safety
ordering), and recompute the state root.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..hash.keccak import keccak256
from . import rlp
from .trie import EMPTY_ROOT, MissingNode, Trie

EMPTY_CODE_HASH = keccak256(b"")


@dataclass
class Account:
    nonce: int
    balance: int
    storage_root: bytes
    code_hash: bytes

    def encode(self) -> bytes:
        return rlp.encode([self.nonce, self.balance,
                           self.storage_root, self.code_hash])

    @classmethod
    def decode(cls, data: bytes) -> "Account":
        n, b, sr, ch = rlp.decode_full(data)
        return cls(int.from_bytes(n, "big"), int.from_bytes(b, "big"),
                   bytes(sr), bytes(ch))


class SparseState:
    """State + storage tries hydrated from witness RLP nodes."""

    def __init__(self, pre_state_root: bytes, witness_nodes: list[bytes],
                 codes: list[bytes] | None = None):
        # hash every witness node once; storage tries link lazily from the
        # account's storage root (SparseState::new, lib.rs:135-155)
        self._nodes = list(witness_nodes)
        self.state = Trie.from_rlp_nodes(self._nodes, pre_state_root)
        self._storage: dict[bytes, Trie] = {}
        self.codes = {keccak256(c): c for c in (codes or [])}

    # -- reads (the EVM host functions; lib.rs:158-186) -------------------

    def account(self, address: bytes) -> Account | None:
        raw = self.state.get(keccak256(address))
        return Account.decode(raw) if raw is not None else None

    def storage_trie(self, address: bytes) -> Trie:
        key = keccak256(address)
        if key not in self._storage:
            acct = self.account(address)
            root = acct.storage_root if acct else EMPTY_ROOT
            self._storage[key] = Trie.from_rlp_nodes(self._nodes, root)
        return self._storage[key]

    def storage(self, address: bytes, slot: bytes) -> int:
        raw = self.storage_trie(address).get(keccak256(slot))
        if raw is None:
            return 0
        return int.from_bytes(rlp.decode_full(raw), "big")

    def code(self, code_hash: bytes) -> bytes | None:
        if code_hash == EMPTY_CODE_HASH:
            return b""
        return self.codes.get(code_hash)

    # -- post-state root (lib.rs:189-240) ---------------------------------

    def calculate_state_root(self, post: dict) -> bytes:
        """Apply a HashedPostState-shaped update set and return the root.

        post: {address: None (destroyed) |
                        (account_fields: dict with nonce/balance/code_hash,
                         storage: {slot: value_int})}
        Inserts are applied before removals (both for storage slots and
        accounts) to avoid unresolvable orphans, mirroring the reference.
        """
        # storage first: per-account storage roots
        inserts, removals = [], []
        for address, update in post.items():
            if update is None:
                removals.append(address)
                continue
            fields, storage = update
            trie = self.storage_trie(address)
            slot_ins = [(s, v) for s, v in storage.items() if v != 0]
            slot_del = [s for s, v in storage.items() if v == 0]
            try:
                for s, v in slot_ins:
                    trie.insert(keccak256(s), rlp.encode(v))
                for s in slot_del:
                    trie.delete(keccak256(s))
            except MissingNode as e:
                # annotate which account's storage trie was insufficient
                # so preflight's orphan recovery can hunt a key preimage
                e.address = address
                raise
            prev = self.account(address)
            acct = Account(
                nonce=fields.get("nonce", prev.nonce if prev else 0),
                balance=fields.get("balance", prev.balance if prev else 0),
                storage_root=trie.root_hash(),
                code_hash=fields.get(
                    "code_hash", prev.code_hash if prev else EMPTY_CODE_HASH),
            )
            inserts.append((address, acct))
        for address, acct in inserts:
            self.state.insert(keccak256(address), acct.encode())
        for address in removals:
            self.state.delete(keccak256(address))
        return self.state.root_hash()
