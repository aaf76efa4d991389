"""The traced run's readings: the device's trace, the prover's stage spans
and the kernels' launch counters, on one clock, for the layer readers.

The profiler's events stay in memory: each device operation is kept as
(name, start, end) and nothing is written to disk. One CPU marker,
recorded at a known ``time.perf_counter`` reading, puts the profiler's
clock onto the spans' clock.
"""

from __future__ import annotations

import re
import time

import numpy as np
import torch

MARK = "bench.clock"


class DeviceProfile:
    """``torch.profiler`` over the window; after it, ``ops`` holds every
    device operation (kernels, copies, sets) as (name, start, end) on
    ``time.perf_counter``'s clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.ops = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.mark_ns = time.perf_counter_ns()
        with record_function(MARK):
            pass
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        events = self.prof.profiler.kineto_results.events()
        mark = next(e for e in events if e.name() == MARK)
        offset = mark.start_ns() - self.mark_ns
        cuda = torch.autograd.DeviceType.CUDA
        self.ops = [(e.name(), (e.start_ns() - offset) * 1e-9,
                     (e.start_ns() + e.duration_ns() - offset) * 1e-9)
                    for e in events if e.device_type() == cuda]
        del self.prof
        return False


def merge(starts: np.ndarray, ends: np.ndarray) -> tuple:
    """The union of intervals, as sorted disjoint (starts, ends)."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > run[:-1]
    first = np.flatnonzero(new)
    last = np.r_[first[1:] - 1, s.size - 1]
    return s[first], run[last]


class Trace:
    """What the layer readers read.

    window: (start, end); units: proofs completed in it; spans: (name,
    depth, start, end) of the prover's stages; launches: the kernels'
    launch counters by (rows, cols); ops: the device operations."""

    def __init__(self, window: tuple, units: int, spans: list,
                 launches: dict, ops: list):
        self.window = window
        self.units = units
        w0, w1 = window
        self.spans = [s for s in spans if s[3] > w0 and s[2] < w1]
        self.launches = launches
        self.ops = [o for o in ops if o[2] > w0 and o[1] < w1]
        s = np.array([max(o[1], w0) for o in self.ops], np.float64)
        e = np.array([min(o[2], w1) for o in self.ops], np.float64)
        self.busy = merge(s, e)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return float((self.busy[1] - self.busy[0]).sum())

    def stage_seconds(self, *names) -> float | None:
        """Seconds of the spans named `names`, summed; None if none ran."""
        got = [s[3] - s[2] for s in self.spans if s[0] in names]
        return sum(got) if got else None

    def per_unit(self, *names) -> float | None:
        """``stage_seconds`` over the proofs of the window."""
        total = self.stage_seconds(*names)
        return None if total is None or not self.units else total / self.units

    def op_seconds(self, pattern: str, outside: tuple = ()) -> float:
        """Device seconds of the operations whose name matches `pattern`
        (a regular expression), leaving out any that start inside a span
        named in `outside`."""
        rx = re.compile(pattern)
        skip = [(s[2], s[3]) for s in self.spans if s[0] in outside]
        return sum(o[2] - o[1] for o in self.ops if rx.search(o[0])
                   and not any(a <= o[1] < b for a, b in skip))

    def device_ops(self, top: int = 10) -> list:
        """[name, device seconds] of the operations that took longest, by
        name."""
        by = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[n[:160], t] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[stage, idle seconds]: the device's idle time in the window,
        each gap charged to the innermost stage open at its middle
        ("outside any stage" where none is), largest first."""
        w0, w1 = self.window
        bs, be = self.busy
        gs = np.r_[w0, be]
        ge = np.r_[bs, w1]
        keep = ge > gs
        gs, ge = gs[keep], ge[keep]
        mid = (gs + ge) / 2
        owner = np.full(mid.size, -1)
        depth = np.full(mid.size, -1)
        length = np.full(mid.size, np.inf)
        for i, (_, d, s, e) in enumerate(self.spans):
            inner = (mid >= s) & (mid < e) & (
                (d > depth) | ((d == depth) & (e - s < length)))
            owner[inner], depth[inner], length[inner] = i, d, e - s
        by = {}
        for i, g in zip(owner, ge - gs):
            name = self.spans[i][0] if i >= 0 else "outside any stage"
            by[name] = by.get(name, 0.0) + float(g)
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]
