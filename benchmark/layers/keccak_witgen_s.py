"""Seconds a batch spends in keccak witness generation on the host
(accelerator batches, ``circuits/keccak.py``): the ``keccak witgen
(host)`` stage, per batch proved in the window."""


def read(trace):
    return trace.per_unit("keccak witgen (host)")
