"""Host orchestration: fetch -> cache -> validate -> prove -> verify.

Replaces zeth-host (SURVEY.md §2.1, crates/host/src/lib.rs): chain
detection, input fetch with JSON caching keyed by block hash
(cli.rs:113-145), host-side validation, and proving dispatch through
the zkvm layer's dev-mode seam.

Input format: the reference's cached `StatelessInput` JSON — {"block":
{..header fields.., "transactions": [...]}, "witness": {"state": [hex],
"codes": [hex], "headers": [hex], "keys": ignored}} (the reference drops
`keys` too, lib.rs:104). Field names accept both camelCase and
snake_case.

Validation scope: header hash recomputation, parent-header linkage,
witness/pre-state-trie integrity, and FULL transaction re-execution
through the native EVM engine (app.evm / csrc/evm.cpp) with all
post-execution header commitments checked: transactions root, receipts
root, logs bloom, gas used, blob gas, and the post-state root
(the reference's reth stateless_validation body). `prove` runs the
stateless-client guest in the zkVM through ``zkvm.default_prover``.

Counterpart of ``zeth_tpu.app.host``, a jax-free copy. The one change:
``BlockProcessor.prove`` takes the port's `device` (None: the CUDA card;
without one a real prove raises). Dev mode (``ZETH_DEV_MODE=1``) needs
no card.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field

from ..hash.keccak import keccak256
from . import rlp
from .chainspec import BY_CHAIN_ID, ChainSpec
from .state import SparseState

# header fields in RLP order: (name, kind, optional_since_fork)
# kind: h=hash/bytes32, a=address, b=raw bytes, i=int
_HEADER_FIELDS = [
    ("parent_hash", "h", None),
    ("ommers_hash", "h", None),
    ("beneficiary", "a", None),
    ("state_root", "h", None),
    ("transactions_root", "h", None),
    ("receipts_root", "h", None),
    ("logs_bloom", "b", None),
    ("difficulty", "i", None),
    ("number", "i", None),
    ("gas_limit", "i", None),
    ("gas_used", "i", None),
    ("timestamp", "i", None),
    ("extra_data", "b", None),
    ("mix_hash", "h", None),
    ("nonce", "b", None),
    ("base_fee_per_gas", "i", "london"),
    ("withdrawals_root", "h", "shanghai"),
    ("blob_gas_used", "i", "cancun"),
    ("excess_blob_gas", "i", "cancun"),
    ("parent_beacon_block_root", "h", "cancun"),
    ("requests_hash", "h", "prague"),
]

_ALIASES = {
    "ommers_hash": ["sha3Uncles", "unclesHash"],
    "beneficiary": ["miner", "coinbase"],
    "mix_hash": ["prevRandao"],
}


def _camel(s: str) -> str:
    parts = s.split("_")
    return parts[0] + "".join(p.capitalize() for p in parts[1:])


def _get_field(d: dict, name: str):
    for k in [name, _camel(name)] + _ALIASES.get(name, []):
        if k in d and d[k] is not None:
            return d[k]
    return None


def _to_bytes(v) -> bytes:
    if isinstance(v, str):
        return bytes.fromhex(v[2:] if v.startswith("0x") else v)
    if isinstance(v, list):
        return bytes(v)
    raise TypeError(type(v))


def _to_int(v) -> int:
    if isinstance(v, str):
        return int(v, 16) if v.startswith("0x") else int(v)
    return int(v)


@dataclass
class Header:
    fields: dict                # name -> decoded value (bytes or int)

    @classmethod
    def from_json(cls, d: dict) -> "Header":
        out = {}
        for name, kind, _ in _HEADER_FIELDS:
            v = _get_field(d, name)
            if v is None:
                continue
            out[name] = _to_int(v) if kind == "i" else _to_bytes(v)
        return cls(out)

    @classmethod
    def from_rlp(cls, raw: bytes) -> "Header":
        items = rlp.decode_full(raw)
        out = {}
        for (name, kind, _), item in zip(_HEADER_FIELDS, items):
            out[name] = int.from_bytes(item, "big") if kind == "i" else bytes(item)
        return cls(out)

    def encode(self) -> bytes:
        items = []
        for name, kind, _ in _HEADER_FIELDS:
            if name not in self.fields:
                continue
            items.append(self.fields[name])
        return rlp.encode(items)

    def hash(self) -> bytes:
        return keccak256(self.encode())

    @property
    def number(self) -> int:
        return self.fields["number"]

    @property
    def state_root(self) -> bytes:
        return self.fields["state_root"]

    @property
    def parent_hash(self) -> bytes:
        return self.fields["parent_hash"]


@dataclass
class ExecutionWitness:
    state: list                 # RLP trie nodes (bytes)
    codes: list                 # contract bytecodes
    headers: list               # RLP-encoded ancestor headers, parent first

    @classmethod
    def from_json(cls, d: dict) -> "ExecutionWitness":
        return cls(
            state=[_to_bytes(x) for x in d.get("state", [])],
            codes=[_to_bytes(x) for x in d.get("codes", [])],
            headers=[_to_bytes(x) for x in d.get("headers", [])],
        )


@dataclass
class StatelessInput:
    block: Header
    transactions: list
    witness: ExecutionWitness
    withdrawals: list = field(default_factory=list)
    raw: dict = field(default_factory=dict, repr=False)

    @classmethod
    def from_json(cls, d: dict) -> "StatelessInput":
        block = d["block"]
        header_src = block.get("header", block)
        body = block.get("body", {})
        return cls(
            block=Header.from_json(header_src),
            transactions=body.get("transactions",
                                  block.get("transactions", [])),
            witness=ExecutionWitness.from_json(d["witness"]),
            withdrawals=body.get("withdrawals",
                                 block.get("withdrawals", [])) or [],
            raw=d,
        )


class ValidationError(Exception):
    pass


def validate_block(input: StatelessInput, spec: ChainSpec) -> bytes:
    """Validate and return the block hash (zeth_core::validate_block role,
    crates/core/src/lib.rs:34-53): header/ancestry/witness checks, then
    full EVM re-execution + post-state root verification."""
    header = input.block
    if header.fields.get("difficulty", 0) != 0:
        raise ValidationError("pre-merge blocks are not supported")

    if not input.witness.headers:
        raise ValidationError("witness has no ancestor headers")
    parent = Header.from_rlp(input.witness.headers[0])
    if parent.hash() != header.parent_hash:
        raise ValidationError("parent header does not match parent_hash")
    if parent.number + 1 != header.number:
        raise ValidationError("parent number mismatch")
    # ancestor chain (BLOCKHASH window) must link
    prev = parent
    for raw in input.witness.headers[1:]:
        h = Header.from_rlp(raw)
        if h.hash() != prev.parent_hash:
            raise ValidationError("broken ancestor header chain")
        prev = h

    # pre-state trie must hydrate from the witness at the parent state root
    from .trie import Digest
    state = SparseState(parent.state_root, input.witness.state,
                        input.witness.codes)
    if state.state.root_hash() != parent.state_root:
        raise ValidationError("witness does not reproduce pre-state root")
    if input.witness.state and isinstance(state.state.root, Digest):
        raise ValidationError("witness is missing the state root node")

    execute_block(input, spec, state, parent)
    return header.hash()


# EIP-4788 beacon roots contract
BEACON_ROOTS_ADDRESS = bytes.fromhex("000f3df6d732807ef1319fb7b8bb8522d0beac02")
# EIP-2935 block-hash history contract (Prague)
HISTORY_STORAGE_ADDRESS = bytes.fromhex(
    "0000f90827f1c53a10cb7a02335b175320002935")
# EIP-7002 withdrawal-requests contract (Prague)
WITHDRAWAL_REQUESTS_ADDRESS = bytes.fromhex(
    "00000961ef480eb55e80d19ad83579a64c007002")
# EIP-7251 consolidation-requests contract (Prague)
CONSOLIDATION_REQUESTS_ADDRESS = bytes.fromhex(
    "0000bbddc7ce488642fb579f8b00f3a590007251")
# EIP-6110 DepositEvent(bytes,bytes,bytes,bytes,bytes) topic
DEPOSIT_EVENT_TOPIC = bytes.fromhex(
    "649bbc62d0e31342afea4e5cd82d4049e7e1ee912fc0889aa790803be39038c5")


def run_block_txs(header: Header, txs, withdrawals, spec: ChainSpec,
                  state, ancestors: dict):
    """Execute a block's transactions against any SparseState-shaped
    state (`account`/`storage`/`code`). Returns (be, cumulative_gas,
    receipts, logs, blob_gas). Shared by stateless validation and the
    rpc-proxy's preflight witness generator (witness.rs:75-87 role)."""
    from . import txs as txs_mod
    from .evm import BlockEvm, ExecutionError, encode_receipt

    timestamp = header.fields["timestamp"]
    is_prague = spec.is_active("prague", timestamp)
    basefee = header.fields.get("base_fee_per_gas", 0)
    excess = header.fields.get("excess_blob_gas", None)
    bp = spec.blob_params_at(timestamp)
    bbf = txs_mod.blob_base_fee(
        excess, bp.base_fee_update_fraction if bp else
        txs_mod.BLOB_BASE_FEE_UPDATE_FRACTION) if excess is not None else 0

    be = BlockEvm(state, ancestors)
    be.set_block(
        coinbase=header.fields["beneficiary"],
        number=header.number,
        timestamp=timestamp,
        gas_limit=header.fields["gas_limit"],
        basefee=basefee,
        prevrandao=header.fields.get("mix_hash", b"\x00" * 32),
        blob_basefee=bbf,
        chain_id=spec.chain_id,
    )
    be.set_fork(is_prague=is_prague)
    beacon_root = header.fields.get("parent_beacon_block_root")
    if beacon_root is not None:
        be.system_call(BEACON_ROOTS_ADDRESS, beacon_root)
    if is_prague:
        # EIP-2935: record the parent hash in the history contract
        be.system_call(HISTORY_STORAGE_ADDRESS, header.parent_hash)

    cumulative = 0
    receipts = []
    all_logs = []
    blob_gas_total = 0
    for i, tx in enumerate(txs):
        if tx.type == 4:
            if not is_prague:
                raise ValidationError(f"tx {i}: type-4 before Prague")
            if tx.to is None or not tx.authorization_list:
                raise ValidationError(f"tx {i}: malformed type-4 tx")
        try:
            sender = tx.sender()
        except ValueError as e:
            raise ValidationError(f"tx {i}: {e}") from e
        eff, tip = tx.effective_gas_price(basefee)
        blob_fee = len(tx.blob_hashes) * txs_mod.GAS_PER_BLOB * bbf \
            if tx.type == 3 else 0
        try:
            res = be.exec_tx(
                sender=sender, to=tx.to, value=tx.value,
                gas_limit=tx.gas_limit, eff_gas_price=eff, tip_per_gas=tip,
                data=tx.data, access_list=tx.access_list,
                blob_hashes=tx.blob_hashes, blob_fee=blob_fee,
                nonce=tx.nonce, authorization_list=tx.authorization_list)
        except ExecutionError as e:
            raise ValidationError(f"tx {i}: {e}") from e
        cumulative += res.gas_used
        receipts.append(encode_receipt(tx.type, res.status, cumulative,
                                       res.logs))
        all_logs += res.logs
        if tx.type == 3:
            blob_gas_total += len(tx.blob_hashes) * txs_mod.GAS_PER_BLOB

    # withdrawals (amounts are gwei)
    for w in withdrawals:
        addr = _to_bytes(_get_field(w, "address") or "0x")
        amount = _to_int(_get_field(w, "amount") or 0)
        if amount:
            be.add_balance(addr, amount * 10**9)

    requests_hash = None
    if is_prague:
        requests_hash = _compute_requests_hash(be, spec, all_logs)
    return be, cumulative, receipts, all_logs, blob_gas_total, requests_hash


def _parse_deposit_log(data: bytes) -> bytes:
    """EIP-6110: extract the raw deposit request from a DepositEvent's
    ABI-encoded data (strict layout check, as the EIP mandates)."""
    # 5 dynamic bytes fields at fixed offsets: pubkey(48),
    # withdrawal_credentials(32), amount(8), signature(96), index(8)
    layout = [(160, 48), (256, 32), (320, 8), (384, 96), (512, 8)]
    if len(data) != 576:
        raise ValidationError("malformed DepositEvent data")
    for i, (off, _) in enumerate(layout):
        want = int.from_bytes(data[32 * i:32 * (i + 1)], "big")
        if want != off:
            raise ValidationError("malformed DepositEvent offsets")
    out = b""
    for off, ln in layout:
        got_len = int.from_bytes(data[off:off + 32], "big")
        if got_len != ln:
            raise ValidationError("malformed DepositEvent field length")
        out += data[off + 32:off + 32 + ln]
    return out


def _compute_requests_hash(be, spec: ChainSpec, all_logs) -> bytes:
    """EIP-7685 requests hash: sha256 over sha256(type || data) of each
    non-empty request, types 0x00 (EIP-6110 deposits from the deposit
    contract's logs), 0x01 (EIP-7002 withdrawal queue), 0x02 (EIP-7251
    consolidation queue)."""
    from .evm import ExecutionError
    deposits = b""
    for log in all_logs:
        if log.address == spec.deposit_contract and log.topics \
                and log.topics[0] == DEPOSIT_EVENT_TOPIC:
            deposits += _parse_deposit_log(log.data)
    try:
        withdrawals_req = be.system_call_out(WITHDRAWAL_REQUESTS_ADDRESS)
        if withdrawals_req is None:
            raise ValidationError("EIP-7002 contract missing or empty")
        consolidations = be.system_call_out(CONSOLIDATION_REQUESTS_ADDRESS)
        if consolidations is None:
            raise ValidationError("EIP-7251 contract missing or empty")
    except ExecutionError as e:
        # a reverting request contract makes the block invalid (EIP-7002)
        raise ValidationError(f"request system call failed: {e}") from e
    acc = b""
    for rtype, rdata in ((0, deposits), (1, withdrawals_req),
                         (2, consolidations)):
        if rdata:
            acc += hashlib.sha256(bytes([rtype]) + rdata).digest()
    return hashlib.sha256(acc).digest()


def execute_block(input: StatelessInput, spec: ChainSpec,
                  state: SparseState, parent: Header) -> None:
    """Re-execute every transaction and check all post-execution header
    commitments (the reference's reth stateless_validation body:
    state root, receipts root, logs bloom, gas used, tx root)."""
    from . import txs as txs_mod
    from .evm import logs_bloom, trie_root

    header = input.block
    txs = [txs_mod.Tx.from_json(t) for t in input.transactions]

    # transactions root binds the tx list to the header
    tx_root = trie_root([t.encode() for t in txs])
    want_tx_root = header.fields.get("transactions_root")
    if want_tx_root is not None and tx_root != want_tx_root:
        raise ValidationError("transactions root mismatch")

    # ancestor hashes for BLOCKHASH
    ancestors = {}
    for raw in input.witness.headers:
        h = Header.from_rlp(raw)
        ancestors[h.number] = h.hash()

    be, cumulative, receipts, all_logs, blob_gas_total, requests_hash = \
        run_block_txs(header, txs, input.withdrawals, spec, state, ancestors)

    want_requests = header.fields.get("requests_hash")
    if requests_hash is not None:
        if want_requests is None:
            raise ValidationError("Prague block without requests_hash")
        if requests_hash != want_requests:
            raise ValidationError("requests hash mismatch")
    elif want_requests is not None:
        raise ValidationError("requests_hash before Prague")

    if cumulative != header.fields.get("gas_used", cumulative):
        raise ValidationError(
            f"gas used mismatch: executed {cumulative}, header says "
            f"{header.fields.get('gas_used')}")
    want_blob = header.fields.get("blob_gas_used")
    if want_blob is not None and blob_gas_total != want_blob:
        raise ValidationError("blob gas used mismatch")
    want_receipts = header.fields.get("receipts_root")
    if want_receipts is not None and trie_root(receipts) != want_receipts:
        raise ValidationError("receipts root mismatch")
    want_bloom = header.fields.get("logs_bloom")
    if want_bloom is not None and logs_bloom(all_logs) != want_bloom:
        raise ValidationError("logs bloom mismatch")

    if be.missing_codes:
        raise ValidationError(
            f"witness is missing {len(be.missing_codes)} contract codes")

    diff = be.state_diff()
    state.codes.update(be.new_code())
    post_root = state.calculate_state_root(diff)
    if post_root != header.state_root:
        raise ValidationError(
            f"post-state root mismatch: computed 0x{post_root.hex()}, "
            f"header says 0x{header.state_root.hex()}")


class BlockProcessor:
    """crates/host BlockProcessor equivalent (lib.rs:30-154)."""

    def __init__(self, spec: ChainSpec, rpc_url: str | None = None):
        self.spec = spec
        self.rpc_url = rpc_url

    @classmethod
    def for_chain_id(cls, chain_id: int, rpc_url: str | None = None):
        if chain_id not in BY_CHAIN_ID:
            raise ValueError(f"unsupported chain id {chain_id}")
        return cls(BY_CHAIN_ID[chain_id], rpc_url)

    # -- cache (cli.rs:113-145) ------------------------------------------

    def cache_path(self, cache_dir: str, block_hash: bytes) -> str:
        return os.path.join(cache_dir, f"input_0x{block_hash.hex()}.json")

    def load_cached_input(self, path: str) -> StatelessInput:
        with open(path) as f:
            data = json.load(f)
        inp = StatelessInput.from_json(data)
        return inp

    def save_input(self, cache_dir: str, inp_json: dict) -> str:
        inp = StatelessInput.from_json(inp_json)
        os.makedirs(cache_dir, exist_ok=True)
        path = self.cache_path(cache_dir, inp.block.hash())
        with open(path, "w") as f:
            json.dump(inp_json, f)
        return path

    # -- rpc fetch (lib.rs:87-110) ---------------------------------------

    def create_input(self, block_id) -> StatelessInput:
        block = self._rpc("eth_getBlockByNumber", [hex(block_id), True]) \
            if isinstance(block_id, int) else \
            self._rpc("eth_getBlockByHash", [block_id, True])
        witness = self._rpc("debug_executionWitness", [block["number"]])
        witness.pop("keys", None)   # dropped, as in the reference (lib.rs:104)
        return StatelessInput.from_json({"block": block, "witness": witness})

    def _rpc(self, method: str, params: list):
        import urllib.request
        if not self.rpc_url:
            raise RuntimeError("no RPC URL configured")
        req = urllib.request.Request(
            self.rpc_url,
            data=json.dumps({"jsonrpc": "2.0", "id": 1, "method": method,
                             "params": params}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as resp:
            out = json.load(resp)
        if "error" in out:
            raise RuntimeError(f"rpc error: {out['error']}")
        return out["result"]

    # -- validate / prove -------------------------------------------------

    def validate(self, inp: StatelessInput) -> bytes:
        return validate_block(inp, self.spec)

    def prove(self, inp: StatelessInput, segment_po2: int | None = None,
              device=None):
        """Prove the block IN the zkVM: host-validate first (cli.rs:96),
        then run the stateless-client guest (zeth_tpu_torch/guest/stateless)
        under default_prover(device) — dev-mode executes only (the
        reference's RISC0_DEV_MODE seam); otherwise every segment and
        accelerator batch is STARK-proven on `device` (None: the CUDA
        card). Returns the receipt; `.stats` carries the executor cycle
        accounting (total/user/paging/keccak — run-parallel.sh:67-70
        categories)."""
        from .. import zkvm
        from ..convert import resolve_device
        from .guest_input import build_stateless_elf, encode_guest_input
        if not zkvm.dev_mode_enabled():
            # a real prove needs its card: raise before the host work
            device = resolve_device(device)
        block_hash = self.validate(inp)
        elf = build_stateless_elf()
        builder = zkvm.ExecutorEnv.builder().write_slice(
            encode_guest_input(inp, self.spec.chain_id))
        if segment_po2 is not None:
            builder = builder.segment_limit_po2(segment_po2)
        info = zkvm.default_prover(device).prove(builder.build(), elf)
        if info.receipt.journal != block_hash:
            raise ValidationError(
                "guest journal does not match the block hash")
        receipt = info.receipt
        receipt.stats = info.stats
        return receipt

    def image_id(self):
        """The image ID a verifier expects for this chain's guest —
        computed independently of any receipt from the guest ELF itself
        (the reference's compute_image_id(elf), cli.rs:100-108)."""
        from ..executor import compute_image_id
        from .guest_input import build_stateless_elf
        return compute_image_id(build_stateless_elf())
