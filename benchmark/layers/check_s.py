"""Seconds of the prover's ``check group`` stage (the constraint tape on
the card, ``zkp/prover.py::prove``) of every proof, per unit proved in
the window."""


def read(trace):
    return trace.per_unit("check group")
