"""The window and idle-share arithmetic on synthetic intervals."""

import numpy as np
import pytest

from harness.trace import Trace, merge
from harness.window import StageSpans


def test_merge_overlapping_and_nested():
    s, e = merge(np.array([5.0, 0.0, 1.0, 8.0, 2.0]),
                 np.array([6.0, 2.0, 1.5, 9.0, 3.0]))
    assert s.tolist() == [0.0, 5.0, 8.0]
    assert e.tolist() == [3.0, 6.0, 9.0]


def _trace(ops, spans=(), window=(0.0, 10.0), units=2, launches=None):
    return Trace(window, units, list(spans), launches or {}, list(ops))


def test_busy_is_the_union_clipped_to_the_window():
    t = _trace([("a", -1.0, 1.0), ("b", 0.5, 2.0), ("c", 4.0, 5.0),
                ("d", 9.5, 12.0), ("e", 20.0, 21.0)])
    assert t.busy_s == pytest.approx(2.0 + 1.0 + 0.5)
    assert t.window_s == 10.0
    assert [o[0] for o in t.ops] == ["a", "b", "c", "d"]


def test_idle_gaps_go_to_the_innermost_stage():
    spans = [("rv32im prove", 0, 0.0, 10.0),
             ("commit main", 0, 2.0, 6.0),
             ("main tree", 1, 3.0, 4.0)]
    t = _trace([("k", 1.0, 2.0), ("k", 3.2, 3.4), ("k", 5.0, 9.0)], spans)
    gaps = dict((n, s) for n, s in t.idle_gaps())
    # 0-1 and 9-10 under "rv32im prove"; 2-3.2 under "commit main" (its
    # middle, 2.6, before "main tree"); 3.4-5.0's middle 4.2 is past
    # "main tree" too
    assert gaps["rv32im prove"] == pytest.approx(2.0)
    assert gaps["commit main"] == pytest.approx(1.2 + 1.6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)


def test_gaps_outside_any_stage_and_an_idle_window():
    t = _trace([], [("x", 0, 0.0, 4.0)])
    assert t.busy_s == 0.0
    assert t.idle_gaps() == [["outside any stage", 10.0]]


def test_stage_sums_per_unit_and_op_seconds():
    spans = [("commit main", 0, 0.0, 1.0), ("commit aux", 0, 1.0, 1.5),
             ("commit main", 0, 5.0, 6.0), ("claims digest", 0, 8.0, 9.0)]
    t = _trace([("row_kernel(uint*)", 0.2, 0.4),
                ("void warp_kernel(x)", 8.1, 8.6),
                ("warp_kernel(x)", 6.0, 6.1), ("elementwise", 2.0, 3.0)],
               spans, units=2)
    assert t.per_unit("commit main", "commit aux") == pytest.approx(1.25)
    assert t.per_unit("no such stage") is None
    pat = r"\b(row|seg|warp)_kernel\b"
    assert t.op_seconds(pat) == pytest.approx(0.2 + 0.5 + 0.1)
    assert t.op_seconds(pat, outside=("claims digest",)) == \
        pytest.approx(0.3)
    assert t.device_ops(2)[0][0] == "elementwise"


def test_stage_spans_record_the_prover_log():
    log = StageSpans()
    log.append(("  main tree", 0.25))
    log.append(("commit main", 1.0))
    assert [s[:2] for s in log.spans] == [("main tree", 1),
                                          ("commit main", 0)]
    name, _, start, end = log.spans[1]
    assert end - start == pytest.approx(1.0)
    assert list(log) == [("  main tree", 0.25), ("commit main", 1.0)]
