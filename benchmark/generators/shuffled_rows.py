"""Recorded rows: ``file``, a CSV of 64-bit words (one row a line, hex
or decimal) relative to the benchmark folder. A round is one array of
every row, in an order drawn from the seed; the warm-up round is the
rows in the file's order. Every seed gives the same rows."""

from __future__ import annotations

import os

import numpy as np


def load(path: str) -> np.ndarray:
    with open(path) as f:
        return np.array([[int(v, 0) for v in line.split(",")]
                         for line in f if line.strip()], np.uint64)


def make(mix: dict, rng, base: str, warm: bool) -> list:
    rows = load(os.path.join(base, mix["file"]))
    return [rows if warm else rows[rng.permutation(len(rows))]]
