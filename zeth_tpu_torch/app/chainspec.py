"""Guest-friendly chain specifications.

Replaces zeth-chainspec (SURVEY.md §2.1, crates/chainspec/src/lib.rs:
40-192): a minimal ordered hardfork->activation table per chain, plus
deposit contract addresses and blob schedules — everything the stateless
validator needs, nothing reth-sized.

Activation is by timestamp for post-merge forks (all zeth-supported
chains are post-merge only; the reference asserts this at
crates/core/src/lib.rs:44-48).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class BlobParams:
    target: int
    max: int
    base_fee_update_fraction: int


@dataclass(frozen=True)
class ChainSpec:
    chain_id: int
    name: str
    # ordered (fork_name, activation_timestamp); post-merge forks only
    forks: tuple
    deposit_contract: bytes
    blob_params: dict = field(default_factory=dict)

    def active_fork(self, timestamp: int) -> str:
        cur = "paris"
        for name, ts in self.forks:
            if timestamp >= ts:
                cur = name
        return cur

    def is_active(self, fork: str, timestamp: int) -> bool:
        for name, ts in self.forks:
            if name == fork:
                return timestamp >= ts
        return False

    def blob_params_at(self, timestamp: int) -> BlobParams | None:
        fork = self.active_fork(timestamp)
        if fork == "osaka" and "osaka" not in self.blob_params:
            fork = "prague"
        return self.blob_params.get(fork)


_BLOBS_CANCUN = BlobParams(3, 6, 3338477)
_BLOBS_PRAGUE = BlobParams(6, 9, 5007716)
# Osaka keeps the Prague schedule at activation (the reference resolves
# per-fork blob params through Osaka — crates/chainspec/src/lib.rs:
# 141-153; BPO revisions land as scheduled overrides, not a new fork
# constant). No Osaka activation timestamp is scheduled in the pinned
# reference snapshot, so the fork entry is added when announced.
_BLOBS_OSAKA = BlobParams(6, 9, 5007716)

MAINNET = ChainSpec(
    chain_id=1,
    name="mainnet",
    forks=(
        ("shanghai", 1681338455),
        ("cancun", 1710338135),
        ("prague", 1746612311),
    ),
    deposit_contract=bytes.fromhex("00000000219ab540356cbb839cbe05303d7705fa"),
    blob_params={"cancun": _BLOBS_CANCUN, "prague": _BLOBS_PRAGUE,
                 "osaka": _BLOBS_OSAKA},
)

SEPOLIA = ChainSpec(
    chain_id=11155111,
    name="sepolia",
    forks=(
        ("shanghai", 1677557088),
        ("cancun", 1706655072),
        ("prague", 1741159776),
    ),
    deposit_contract=bytes.fromhex("7f02c3e3c98b133055b8b348b2ac625669ed295d"),
    blob_params={"cancun": _BLOBS_CANCUN, "prague": _BLOBS_PRAGUE,
                 "osaka": _BLOBS_OSAKA},
)

HOLESKY = ChainSpec(
    chain_id=17000,
    name="holesky",
    forks=(
        ("shanghai", 1696000704),
        ("cancun", 1707305664),
        ("prague", 1740434112),
    ),
    deposit_contract=bytes.fromhex("4242424242424242424242424242424242424242"),
    blob_params={"cancun": _BLOBS_CANCUN, "prague": _BLOBS_PRAGUE,
                 "osaka": _BLOBS_OSAKA},
)

HOODI = ChainSpec(
    chain_id=560048,
    name="hoodi",
    forks=(
        ("shanghai", 0),
        ("cancun", 0),
        ("prague", 1742999832),
    ),
    deposit_contract=bytes.fromhex("00000000219ab540356cbb839cbe05303d7705fa"),
    blob_params={"cancun": _BLOBS_CANCUN, "prague": _BLOBS_PRAGUE,
                 "osaka": _BLOBS_OSAKA},
)

BY_CHAIN_ID = {c.chain_id: c for c in (MAINNET, SEPOLIA, HOLESKY, HOODI)}
