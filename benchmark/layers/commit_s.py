"""Seconds of the prover's commit stages (``zkp/prover.py::prove``): the
``commit control``, ``commit main`` and ``commit aux`` stages of every
proof, per unit proved in the window (for a segment, its rv32im and its
paging proof; the paging main trace's commit is inside ``paging witness
+ commit``)."""


def read(trace):
    return trace.per_unit("commit control", "commit main", "commit aux")
