"""One closed-loop prover: each unit (one proof) starts when the last one
ends, as a prover node works through its queue. No round starts once
``seconds`` have passed, so the window closes at the end of the round in
flight and holds whole rounds. A unit that raises counts as failed; the
prover goes on with the next."""

from __future__ import annotations

import sys
import time
import traceback

import torch

from harness.window import Window


def run(work, rounds, seconds: float, device, mix: dict) -> Window:
    """Prove rounds from the iterator `rounds` with ``work.prove`` until
    `seconds` have passed at the end of a round; the mix `mix` sets
    nothing here."""
    w = Window()
    w.start = time.perf_counter()
    while True:
        for unit in next(rounds):
            w.attempted += 1
            t0 = time.perf_counter()
            try:
                out = work.prove(unit)
            except Exception:
                traceback.print_exc(file=sys.stderr)
                w.failed += 1
                out = None
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            w.done.append((unit, out, t0, time.perf_counter()))
        if time.perf_counter() - w.start >= seconds:
            break
    w.end = time.perf_counter()
    return w
