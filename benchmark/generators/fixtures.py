"""Fixture files: ``files``, data files relative to the benchmark folder.
A round is every file once, in an order drawn from the seed; the warm-up
round is every file in the listed order."""

from __future__ import annotations

import os


def make(mix: dict, rng, base: str, warm: bool) -> list:
    files = [os.path.join(base, f) for f in mix["files"]]
    order = range(len(files)) if warm else rng.permutation(len(files))
    return [files[i] for i in order]
