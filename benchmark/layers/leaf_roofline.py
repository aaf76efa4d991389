"""Percent of its roofline at which the Poseidon2 leaf kernel ran
(``kernels/csrc/poseidon2_leaf.cu`` behind ``hash/poseidon2.py::
leaf_hash``): the least time of every leaf launch of the window,
``peaks.leaf_bound_ms`` at the published peaks, summed over the kernel's
launch counter by (rows, cols), over the device time of its launches in
the profiler's trace.

The leaf library's functions are ``row_kernel``, ``seg_kernel`` and
``warp_kernel`` (one thread, 8 lanes or a warp a row); the sponge kernel's
one-row launches share ``warp_kernel``'s name and run only in the
``claims digest`` stage, so device time that starts there is left out.
None where the window launched no leaf or the trace shows none of its
device time."""

from harness.peaks import leaf_bound_ms

KERNELS = r"\b(row|seg|warp)_kernel\b"


def read(trace):
    shapes = trace.launches.get("poseidon2_leaf", {})
    bound_ms = sum(n * leaf_bound_ms(r, c)[0] for (r, c), n in shapes.items())
    device_s = trace.op_seconds(KERNELS, outside=("claims digest",))
    if not shapes or device_s <= 0:
        return None
    return 100.0 * bound_ms * 1e-3 / device_s
