"""The table of peaks, and the least time of a Poseidon2 leaf launch.

NVIDIA's data sheet for the H100 SXM (dense rates, at its 700 W limit and
1.98 GHz boost clock): HBM bytes/s; float32 outside the tensor cores,
67e12 operations/s with an FMA counted as two: 132 SMs x 4 schedulers x
32 lanes x 1.98 GHz instructions. A scheduler issues one warp instruction
a cycle, so no mix of instructions runs faster than PEAK_ISSUE. Integer
instructions go to two pipes of 16 lanes a scheduler each, PEAK_PIPE
apiece: integer multiplies to the FMA pipe, selects, min/max and logic to
the ALU pipe.

``leaf_bound_ms`` is a frozen copy of ``chip_smoke.leaf_bound_ms``: it
counts the work from the shapes and the permutation's rounds, not from
any one implementation's instructions, so it reads the same work
whatever kernel computes the leaves.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_ISSUE = 67e12 / 2
PEAK_PIPE = 67e12 / 4


def leaf_bound_ms(rows: int, cols: int) -> tuple:
    """(least ms the card could take for the leaf sponge of a (rows,
    cols) matrix, what bounds it).

    Bytes: the matrix read once, the digests written once. Operations: one
    width-24 permutation per 16 absorbed columns; a permutation is 8 full
    and 21 partial rounds, 8*24*4 + 21*(4+24) Montgomery products and
    9*128 + 213 + 21*47 + 16 modular additions. A product is three
    integer multiplies (a b, m = t p' mod 2^32, m p), one addition and one
    select (the conditional subtract); a modular addition one addition and
    one select. The multiplies need the FMA pipe and the selects the ALU
    pipe, PEAK_PIPE each; all of them issue at PEAK_ISSUE. The operations'
    time is the longest of the three."""
    perms = rows * -(-cols // 16)
    products = 8 * 24 * 4 + 21 * (4 + 24)
    additions = 9 * 128 + (8 * 24 + 21) + 21 * 47 + 16
    multiplies = 3 * products
    selects = products + additions
    total = multiplies + selects + products + additions
    ops_ms = perms * max(multiplies / PEAK_PIPE, selects / PEAK_PIPE,
                         total / PEAK_ISSUE) * 1e3
    bytes_ms = (rows * cols * 4 + rows * 8 * 4) / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), \
        "operations" if ops_ms >= bytes_ms else "bytes"
