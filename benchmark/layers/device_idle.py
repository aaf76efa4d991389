"""Percent of the traced window in which no operation ran on the device:
one minus the union of its kernels', copies' and sets' intervals from
``torch.profiler``, over the window. None where the trace holds no
device operation."""


def read(trace):
    if not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
