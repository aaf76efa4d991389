"""Seconds a segment spends in rv32im witness generation on the host
(segment orchestration, ``circuits/rv32im.py::prove_segments``): the
``rv32im witgen (host)`` stage, per segment proved in the window."""


def read(trace):
    return trace.per_unit("rv32im witgen (host)")
