"""Conversion between the JAX package's uint32 numpy arrays and the
port's int32 tensors.

The reference keeps field elements as uint32; the port keeps the same
bit patterns as int32 (every element is below p < 2^31, so the two agree
value for value). These helpers carry seeded numpy inputs and constant
tables across, so the tests can feed both packages the same data.
"""

from __future__ import annotations

import numpy as np
import torch

from .hostmath import P


def resolve_device(device=None, mesh=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. With ``device=None`` and no card this raises; it never
    falls back to the CPU. With a `mesh` each rank's shard goes to card
    ``local_rank % device_count`` (ranks beyond the card count share
    cards)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "zeth_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    if mesh is not None:
        from .parallel.multihost import local_rank
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return torch.device("cuda")


def to_tensor(a, device=None) -> torch.Tensor:
    """uint32/uint64/int numpy array of field elements (< p) -> int32 tensor
    on `device` (None: the CUDA card)."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype != np.uint32:
        a = a.astype(np.uint64)
        if not (a < P).all():
            raise ValueError("field elements must be reduced below p")
        a = a.astype(np.uint32)
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy()) \
        .to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of field elements -> uint32 numpy array."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32).copy()
