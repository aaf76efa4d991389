"""The benchmark's plain reference: a STARK verifier and the claims it
checks, in numpy and plain torch, importing nothing of the program.

``check`` is the entry point: it verifies each seal the timed path made
and compares the claims the seals bind with what it works out itself
from the same inputs. The other modules are frozen copies of the
verifier path of ``zeth_tpu_torch`` (named in each docstring, imports
rewritten to this package, witness generation and every kernel left
out), and the reference's own: ``keccakf`` (FIPS 202), ``sha256``
(FIPS 180-4), ``elf`` (the initial memory image of an ELF) and
``sponge`` (the Poseidon2 sponge of long rows, lean numpy).
"""
