"""The frozen leaf bound against the figures of PERF.md's kernel table
(by pipe, at the published peaks)."""

import pytest

from harness.peaks import leaf_bound_ms


@pytest.mark.parametrize("rows,cols,ms", [
    (1000, 37, 0.001), (4096, 1009, 0.090), (16384, 4161, 1.470),
    (131072, 3410, 9.642), (2097152, 84, 4.326), (4194304, 1009, 92.278)])
def test_leaf_bound_matches_the_table(rows, cols, ms):
    got, what = leaf_bound_ms(rows, cols)
    assert round(got, 3) == ms
    assert what == "operations"


def test_leaf_bound_formula():
    # one permutation per 16 columns: 1,356 products and 2,368 additions,
    # 11,516 instructions in all, which issue slower than either pipe
    # fills (4,068 multiplies, 3,724 selects)
    ms, _ = leaf_bound_ms(1, 16)
    assert ms == pytest.approx(11516 / (67e12 / 2) * 1e3)
    assert leaf_bound_ms(1, 17)[0] == pytest.approx(2 * ms)
