"""One run of one cell: set-up, the window, the reading, the check.

``run`` is the whole run after the look for a chip, so tests drive it on
the CPU at small sizes. Its result is the line the run prints, less the
JAX check, which the caller makes once everything has run.
"""

from __future__ import annotations

import gc
import time

import torch

from . import traffic, window
from .trace import DeviceProfile, Trace

GIB = 2 ** 30


def verdict(counts: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number compared is a
    count of proofs or claim values that came out wrong, held to 0."""
    check = {k: {"value": v, "limit": 0} for k, v in counts.items()}
    return all(c["value"] <= c["limit"] for c in check.values()), check


def run(cell, seed: int, seconds: float, trace: bool, device,
        started: float) -> dict:
    """Run `cell` (a ``spec.Cell``) once; `started` is the process's start
    on ``time.perf_counter``. Returns the result's fields."""
    from zeth_tpu_torch import kernels
    from zeth_tpu_torch.zkp import prover

    cuda = torch.device(device).type == "cuda"
    work = cell.entry.Workload(cell.config, device)
    work.setup(traffic.warmup(cell.generator, cell.traffic, seed, cell.dir))
    rounds = traffic.rounds(cell.generator, cell.traffic, seed, cell.dir)
    setup_peak = window_peak = 0
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - started

    if trace:
        spans = window.StageSpans()
        kept_log, kept_timing = prover.STAGE_LOG, prover.TIMING
        prover.STAGE_LOG, prover.TIMING = spans, True
        kernels.reset_counts()
        try:
            with DeviceProfile(device) as prof:
                w = cell.schedule.run(work, rounds, seconds, device,
                                      cell.traffic)
        finally:
            prover.STAGE_LOG, prover.TIMING = kept_log, kept_timing
        tr = Trace((w.start, w.end), len(w.done) - w.failed, spans.spans,
                   {k: dict(v) for k, v in kernels.LAUNCH_SHAPES.items()},
                   prof.ops)
    else:
        w = cell.schedule.run(work, rounds, seconds, device,
                                      cell.traffic)
    if cuda:
        window_peak = torch.cuda.max_memory_allocated(device)

    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": max(setup_peak, window_peak),
    }
    metrics = {}
    if trace:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        for m in cell.per_layer:
            value = cell.reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        proved = [u for u, out, _, _ in w.done if out is not None]
        values = cell.entry.metrics(sum(work.work(u) for u in proved),
                                    len(proved), w.seconds)
        values.update(peak_device_gib=window_peak / GIB, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    attempted, failed = w.attempted, w.failed
    breakdown = ({"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
                 if trace else None)
    answers = work.answers(w.done)
    del work, w
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts = cell.entry.check(answers, seed, device)
    counts["proves_failed"] = failed
    return {"attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device_info, "breakdown": breakdown, "counts": counts,
            "reference_s": time.perf_counter() - t0}
