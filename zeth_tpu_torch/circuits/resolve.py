"""The recursion hooks that the accelerator AIRs share.

The keccak, bigint and sha batch AIRs lay out their publics the same
way: the call count, then the 16-bit IO limb stream. Each derives its one
challenge as the Horner RLC of that stream under ``challenges[0]``. The
lift program (``recursion.compiler``) rebuilds that challenge in circuit
through ``derived_challenges_rec``; lifting a batch proof pins its
publics in the lift claim, so the root receipt's claim fold discharges
the accelerator assumption with no host-side STARK re-verification (the
reference's in-circuit resolve).

Port note: one copy of the hooks that ``zeth_tpu.circuits.keccak``,
``bigint2`` and ``sha256`` each define; the values are the same.
"""

from __future__ import annotations


class LimbStreamResolve:
    """``publics_shape`` / ``derived_challenges_rec`` for an AIR whose
    publics are [calls, limb, limb, ...]."""

    def publics_shape(self, publics):
        return int(publics[0])

    def derived_challenges_rec(self, b, pub_cells, chal_ext, pub_shape,
                               extra_cells=None):
        """In-circuit mirror of derived_challenges for the lift program:
        Horner RLC over the public limb stream, in the order the host
        derivation consumes it."""
        b.assert_eq(pub_cells[0], int(pub_shape))
        g = chal_ext[0]
        acc = b.ZERO
        for c in pub_cells[1:]:
            acc = b.fma(a=acc, b=g, c=c, d=b.ONE, s0=1, s1=1)
        return [acc]
