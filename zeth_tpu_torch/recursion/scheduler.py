"""Lift/join DAG scheduler for segment proofs.

The reference proves segments independently and merges them with a
binary join tree (SURVEY.md §2.3 "segment parallelism": segments are
provable independently, then merged by recursion lift/join). This module
is the host-side scheduler for that shape:

- each *lift* task proves one executor segment (device-bound work);
- each *join* node merges two child claims into a parent claim digest
  (Poseidon2 of the pair — the binding the future recursion circuit will
  verify in-circuit);
- tasks are idempotent and re-dispatchable: a lost worker re-proves only
  its own segments (SURVEY.md §5 failure-detection note).

Workers are pluggable: the default executes locally (one device); a
multi-host deployment passes an executor mapping task -> host/chip.

Port note: a jax-free copy of ``zeth_tpu.recursion.scheduler`` (host
hashing only).
"""

from __future__ import annotations

from concurrent.futures import Executor as _PyExecutor, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..hash import poseidon2 as P2


@dataclass
class ProveTask:
    """One lift task: prove segment `index` (idempotent)."""
    index: int
    segment: object
    attempts: int = 0
    seal: np.ndarray | None = None


@dataclass
class JoinNode:
    left: object     # JoinNode | int (leaf segment index)
    right: object | None
    claim: np.ndarray | None = None


def _leaf_claim(seal: np.ndarray) -> np.ndarray:
    """Claim digest of one segment seal (hash of its words, 16-bit split)."""
    w = np.asarray(seal, dtype=np.uint64)
    halves = np.stack([w & 0xFFFF, w >> np.uint64(16)], -1).reshape(1, -1)
    return P2.hash_rows_np(halves)[0]


def join_claims(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Parent claim = Poseidon2(left_claim, right_claim)."""
    return P2.hash_pairs_np(left[None], right[None])[0]


@dataclass
class JoinTree:
    """Result of aggregation: root claim + the per-segment seals."""
    root_claim: np.ndarray
    seals: list
    depth: int
    retries: int = 0


def aggregate_segments(segments: list, prove_fn, max_workers: int = 1,
                       max_retries: int = 2,
                       pool: _PyExecutor | None = None) -> JoinTree:
    """Prove all segments (fan-out) and fold claims up the join tree.

    prove_fn(segment) -> seal (np.uint32). Lift tasks run on the worker
    pool; joins are cheap host hashing. Failed tasks are retried up to
    max_retries times (idempotent re-dispatch).
    """
    tasks = [ProveTask(i, s) for i, s in enumerate(segments)]
    retries = 0

    def run(task: ProveTask):
        task.attempts += 1
        task.seal = prove_fn(task.segment)
        return task

    own_pool = pool is None
    pool = pool or ThreadPoolExecutor(max_workers=max_workers)
    try:
        pending = list(tasks)
        while pending:
            futures = {pool.submit(run, t): t for t in pending}
            pending = []
            for fut, t in futures.items():
                try:
                    fut.result()
                except Exception:
                    if t.attempts > max_retries:
                        raise
                    retries += 1
                    pending.append(t)
    finally:
        if own_pool:
            pool.shutdown()

    claims = [_leaf_claim(t.seal) for t in tasks]
    depth = 0
    while len(claims) > 1:
        nxt = []
        for i in range(0, len(claims) - 1, 2):
            nxt.append(join_claims(claims[i], claims[i + 1]))
        if len(claims) % 2:
            nxt.append(claims[-1])
        claims = nxt
        depth += 1
    return JoinTree(root_claim=claims[0], seals=[t.seal for t in tasks],
                    depth=depth, retries=retries)
