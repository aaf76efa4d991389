"""Preflight witness generation: EVM re-execution over a recording RPC DB.

Replaces the reference proxy's witness pipeline (SURVEY.md §3.4,
crates/rpc-proxy/src/{witness.rs,db/preflight.rs,db/provider.rs,trie.rs}):
execute the block against an RPC-backed state that records every touched
account/slot/code/blockhash, then assemble the minimal MPT node set from
chunked `eth_getProof` responses — pre-state proofs for everything read,
post-state proofs for changed keys so deletions' orphan nodes hydrate
(the reference's handle_new/removed/modified_account, trie.rs:27-140).
"""

from __future__ import annotations

from ..hash.keccak import keccak256
from .host import Header, ValidationError, run_block_txs
from .state import Account, EMPTY_CODE_HASH
from .trie import EMPTY_ROOT

# eth_getProof slot chunking (provider.rs eip1186_proof_chunk_size = 1000)
PROOF_CHUNK = 1000


def _hx(b: bytes) -> str:
    return "0x" + b.hex()


def _to_bytes(v) -> bytes:
    if v in (None, "0x", ""):
        return b""
    h = v[2:] if isinstance(v, str) and v.startswith("0x") else v
    if isinstance(h, str):
        if len(h) % 2:
            h = "0" + h
        return bytes.fromhex(h)
    return bytes(v)


def _to_int(v) -> int:
    if v is None:
        return 0
    if isinstance(v, str):
        return int(v, 16) if v.startswith("0x") else int(v)
    return int(v)


class ProviderState:
    """SparseState-shaped reads over RPC, recording everything served
    (the PreflightDb + ProviderDb pair, db/preflight.rs:46-286)."""

    def __init__(self, upstream, parent_tag: str):
        self.upstream = upstream
        self.tag = parent_tag
        self.accounts: dict[bytes, Account | None] = {}
        self.slots: dict[bytes, dict[bytes, int]] = {}
        self.codes: dict[bytes, bytes] = {EMPTY_CODE_HASH: b""}
        self.min_blockhash: int | None = None

    def account(self, addr: bytes) -> Account | None:
        if addr in self.accounts:
            return self.accounts[addr]
        p = self.upstream.call("eth_getProof", [_hx(addr), [], self.tag])
        balance = _to_int(p.get("balance"))
        nonce = _to_int(p.get("nonce"))
        code_hash = _to_bytes(p.get("codeHash")) or EMPTY_CODE_HASH
        storage_root = _to_bytes(p.get("storageHash")) or EMPTY_ROOT
        exists = not (balance == 0 and nonce == 0
                      and code_hash == EMPTY_CODE_HASH
                      and storage_root == EMPTY_ROOT)
        acct = Account(nonce, balance, storage_root, code_hash) \
            if exists else None
        self.accounts[addr] = acct
        if acct and acct.code_hash != EMPTY_CODE_HASH \
                and acct.code_hash not in self.codes:
            code = _to_bytes(self.upstream.call(
                "eth_getCode", [_hx(addr), self.tag]))
            if keccak256(code) != acct.code_hash:
                raise ValidationError(
                    f"upstream code does not hash to codeHash for "
                    f"0x{addr.hex()}")
            self.codes[acct.code_hash] = code
        return acct

    def storage(self, addr: bytes, slot: bytes) -> int:
        per = self.slots.setdefault(addr, {})
        if slot in per:
            return per[slot]
        v = _to_int(self.upstream.call(
            "eth_getStorageAt", [_hx(addr), _hx(slot), self.tag]))
        per[slot] = v
        # make sure the account itself is recorded too
        self.account(addr)
        return v

    def code(self, code_hash: bytes) -> bytes | None:
        return self.codes.get(code_hash)


def execution_witness(upstream, block_number: str, spec) -> dict:
    """Full preflight: fetch, re-execute, assemble the witness dict
    ({state, codes, keys, headers} — the reference's ExecutionWitness,
    witness.rs:112-131)."""
    from . import txs as txs_mod

    block_json = upstream.call("eth_getBlockByNumber", [block_number, True])
    header = Header.from_json(block_json.get("header", block_json))
    parent_json = upstream.call(
        "eth_getBlockByHash", [block_json["parentHash"], False])
    parent = Header.from_json(parent_json.get("header", parent_json))
    parent_tag = hex(parent.number)

    state = ProviderState(upstream, parent_tag)
    txs = [txs_mod.Tx.from_json(t)
           for t in block_json.get("transactions", [])]
    withdrawals = block_json.get("withdrawals", []) or []

    # ancestor headers: start with the parent; extend to the BLOCKHASH
    # window actually used (recorded via the ancestors dict misses)
    ancestors: dict[int, bytes] = {}
    header_rlps: list[bytes] = []
    cur = parent
    header_rlps.append(cur.encode())
    ancestors[cur.number] = cur.hash()

    class RecordingAncestors(dict):
        def get(self, number, default=None):
            nonlocal cur
            while number < min(ancestors) and len(header_rlps) < 256:
                nxt_json = upstream.call(
                    "eth_getBlockByHash", [_hx(cur.parent_hash), False])
                cur = Header.from_json(nxt_json.get("header", nxt_json))
                header_rlps.append(cur.encode())
                ancestors[cur.number] = cur.hash()
            return ancestors.get(number, default)

    be, cumulative, receipts, logs, blob_gas, _requests = run_block_txs(
        header, txs, withdrawals, spec, state, RecordingAncestors())

    # the diff decides which keys need post-state hydration
    diff = be.state_diff()

    # -- assemble proofs ----------------------------------------------------
    nodes: list[str] = []
    seen: set[str] = set()

    def add_nodes(ns):
        for node in ns or []:
            if node not in seen:
                seen.add(node)
                nodes.append(node)

    def fetch_proof(addr: bytes, slot_keys: list[bytes], tag: str):
        for off in range(0, max(len(slot_keys), 1), PROOF_CHUNK):
            chunk = slot_keys[off:off + PROOF_CHUNK]
            p = upstream.call("eth_getProof",
                             [_hx(addr), [_hx(s) for s in chunk], tag])
            add_nodes(p.get("accountProof"))
            for sp in p.get("storageProof", []):
                add_nodes(sp.get("proof"))

    # pre-state proofs for every touched account/slot
    touched = dict(state.slots)
    for a in state.accounts:
        touched.setdefault(a, {})
    for addr, per in sorted(touched.items()):
        fetch_proof(addr, sorted(per.keys()), parent_tag)

    # post-state hydration for changed keys (new/removed/modified paths,
    # incl. deletion orphans — trie.rs:27-140's role)
    post_tag = hex(header.number)
    for addr, update in sorted(diff.items()):
        if update is None:
            fetch_proof(addr, [], post_tag)
            continue
        _, slots = update
        flip = [s for s, v in slots.items()]
        fetch_proof(addr, sorted(flip), post_tag)

    # -- witness self-check + orphan recovery -------------------------------
    # Replay the post-state root computation over the assembled node set.
    # A deletion that collapses a branch into an untouched sibling raises
    # MissingNode with the sibling's path prefix; recover its RLP by
    # (a) un-merging a post-state proof node (the reference's
    # resolve_orphan, trie.rs:104-118), else (b) hunting a key preimage
    # under the prefix via debug_storageRangeAt and fetching its
    # pre-state proof (rpc.rs:45-95).
    from .state import SparseState
    from .trie import MissingNode

    codes = [c for h, c in state.codes.items() if c]
    node_bytes = [_to_bytes(n) for n in nodes]
    root = None
    for _ in range(64):
        ss = SparseState(parent.state_root, node_bytes, codes)
        try:
            root = ss.calculate_state_root(diff)
            break
        except MissingNode as e:
            want = bytes.fromhex(e.digest_hex)
            unmerged = _unmerge_orphan(node_bytes, want)
            if unmerged is not None:
                node_bytes.append(unmerged)
                add_nodes([_hx(unmerged)])
                continue
            if e.address is None or not e.prefix:
                raise ValidationError(
                    f"witness insufficient: unresolved node {e.digest_hex}"
                    " outside any storage trie") from e
            key = _next_storage_key(upstream, _hx(header.hash()),
                                    e.address, e.prefix)
            before = len(nodes)
            fetch_proof(e.address, [key], parent_tag)
            if len(nodes) == before:
                raise ValidationError(
                    "orphan recovery made no progress for "
                    f"0x{e.address.hex()} prefix {e.prefix}") from e
            node_bytes = [_to_bytes(n) for n in nodes]
    else:
        raise ValidationError("orphan recovery did not converge")
    if root != header.state_root:
        raise ValidationError(
            "assembled witness does not reproduce the header state root")
    return {
        "state": nodes,
        "codes": [_hx(c) for c in codes],
        "keys": [],
        "headers": [_hx(r) for r in header_rlps],
    }


def _unmerge_orphan(node_bytes: list[bytes], want: bytes):
    """Derive a pre-state sibling node from post-state proof nodes.

    After deleting the last other child of a branch, the sibling S moves
    up: post-state contains S' = S with the branch nibble prepended to
    its path. Reverse it: for every witness leaf/extension node, strip
    the first path nibble and check the re-encoding hashes to the
    missing digest (risc0-ethereum-trie orphan resolution's role)."""
    from . import rlp as rlp_mod
    from .trie import decode_hex_prefix, hex_prefix

    for raw in node_bytes:
        try:
            items = rlp_mod.decode_full(raw)
        except Exception:
            continue
        if not isinstance(items, list) or len(items) != 2:
            continue
        try:
            path, leaf = decode_hex_prefix(bytes(items[0]))
        except Exception:
            continue
        if not path:
            continue
        stripped = rlp_mod.encode(
            [hex_prefix(tuple(path[1:]), leaf), items[1]])
        if len(stripped) >= 32 and keccak256(stripped) == want:
            return stripped
    return None


def _next_storage_key(upstream, block_hash_hex: str, address: bytes,
                      prefix: tuple) -> bytes:
    """debug_storageRangeAt preimage hunt: the next storage key whose
    keccak starts with `prefix` nibbles, at the pre-state of the block
    (txIndex 0). Sanity-checks the wonky RPC (rpc.rs:87-91)."""
    packed = bytearray()
    for i in range(0, len(prefix) - 1, 2):
        packed.append(prefix[i] << 4 | prefix[i + 1])
    if len(prefix) % 2:
        packed.append(prefix[-1] << 4)
    start = bytes(packed).ljust(32, b"\x00")
    resp = upstream.call("debug_storageRangeAt",
                         [block_hash_hex, 0, _hx(address), _hx(start), 1])
    storage = resp.get("storage") or {}
    for _, entry in storage.items():
        key = entry.get("key")
        if key is None:
            raise ValidationError(
                "preimage storage key missing from debug_storageRangeAt")
        kb = _to_bytes(key).rjust(32, b"\x00")
        kn = []
        for b in keccak256(kb):
            kn.extend((b >> 4, b & 0xF))
        if tuple(kn[:len(prefix)]) != tuple(prefix):
            raise ValidationError("invalid debug_storageRangeAt response")
        return kb
    raise ValidationError("no storage slot from debug_storageRangeAt")
