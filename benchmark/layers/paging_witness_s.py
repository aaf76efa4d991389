"""Seconds a segment spends building and committing its paging proof's
main trace (segment orchestration, ``circuits/paging.py``): the
``paging witness + commit`` stage, per segment proved in the window."""


def read(trace):
    return trace.per_unit("paging witness + commit")
