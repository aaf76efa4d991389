"""A mix's data file and a seed in, rounds of units out.

A mix, ``traffic/<name>.json``, is data: its ``generator`` names the
module ``generators/<generator>.py`` that turns its parameters into
units, and its ``schedule`` (``closed`` where it names none) the module
``schedules/<schedule>.py`` that offers them to the program in the
window. A round is the list of units the window works through before it
may close, so every round of a mix is the same work.

A generator's ``make(mix, rng, base, warm)`` returns one round drawn
from the numpy generator `rng`, with paths relative to the benchmark
folder `base`; with `warm` it returns the round the set-up runs: every
distinct input the mix will use, or one of the same shapes from a
stream the window never draws from.
"""

from __future__ import annotations

import numpy as np


def _stream(seed: int, which: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), which])


def rounds(generator, mix: dict, seed: int, base: str):
    """Endless rounds of the mix, drawn from `seed`."""
    rng = _stream(seed, 0)
    while True:
        yield generator.make(mix, rng, base, warm=False)


def warmup(generator, mix: dict, seed: int, base: str) -> list:
    return generator.make(mix, _stream(seed, 1), base, warm=True)
