"""The measured window's record, and the stage spans it leaves.

How units are offered in the window is the mix's schedule
(``schedules/<name>.py``, whose ``run(work, rounds, seconds, device,
mix)`` returns a ``Window``; `mix` is the mix's data, where an open-loop
schedule finds its arrivals)."""

from __future__ import annotations

import time


class StageSpans(list):
    """Stands in for ``prover.STAGE_LOG`` while the window is traced: the
    prover appends (name, seconds) at each stage's end, after it
    synchronises the device, and this records the end on
    ``time.perf_counter``, so each stage becomes a span (name, depth,
    start, end). Nesting is the name's indentation, two spaces a level."""

    def __init__(self):
        super().__init__()
        self.spans = []

    def append(self, entry):
        end = time.perf_counter()
        name, dt = entry
        depth = (len(name) - len(name.lstrip(" "))) // 2
        self.spans.append((name.strip(), depth, end - dt, end))
        super().append(entry)


class Window:
    """What one window did: units attempted and failed, each unit's
    (input, output, start, end), and the window's bounds."""

    def __init__(self):
        self.done = []
        self.attempted = 0
        self.failed = 0
        self.start = self.end = 0.0

    @property
    def seconds(self) -> float:
        return self.end - self.start

