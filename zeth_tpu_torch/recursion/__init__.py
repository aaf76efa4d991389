"""Segment aggregation: the lift/join scheduler and the recursion circuit.

Maps the reference's recursion pipeline (SURVEY.md §2.2,
risc0-circuit-recursion: lift each rv32im segment receipt to a succinct
receipt, join pairs until one remains, resolve accelerator assumptions).
Jax-free copy of ``zeth_tpu.recursion``:

- ``scheduler``: the host DAG scheduler (fan-out, retries, claim folding);
- ``vm``: the recursion VM's AIR and its interpreters (``witgen_native``
  loads the C++ one from ``executor/csrc/recvm.cpp``);
- ``builder`` and ``compiler``: the STARK verifier as a recursion program;
- ``succinct``: ``lift`` / ``join`` / ``aggregate_segments`` proved on a
  device, and ``verify_root*``, which the succinct receipt
  (``zkvm.SuccinctInner``) uses.
"""

from .scheduler import JoinTree, ProveTask, aggregate_segments  # noqa: F401
