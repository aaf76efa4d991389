"""The port's copy of the C++ executor against zeth_tpu.executor.

``zeth_tpu_torch.executor`` carries the reference's emulator and guest
tooling so that the port imports nothing of the JAX package. The two
must agree: the same guest ELF bytes, the same memory image and image
ID, and the same segments, trace records and memory lists.
"""

import numpy as np
import pytest

from zeth_tpu import executor as JEX
from zeth_tpu.executor import guests as JG
from zeth_tpu_torch import executor as TEX
from zeth_tpu_torch.executor import guests as TG

# (guest, its arguments, segment_po2): one short halting segment, a run
# cut into several segments, page traffic, and the syscall streams
CASES = [
    ("spin", (1503,), 12),
    ("spin", (6000,), 12),
    ("memory_stress", (6,), 20),
    ("echo_input", (16,), 20),
    ("keccak_guest", (2,), 20),
]


@pytest.mark.parametrize("name,args,po2", CASES)
def test_executor_copy_equals_reference(name, args, po2):
    elf = getattr(TG, name)(*args)
    assert elf == getattr(JG, name)(*args)
    t_entry, t_a, t_w = TEX.load_image(elf)
    j_entry, j_a, j_w = JEX.load_image(elf)
    assert t_entry == j_entry
    np.testing.assert_array_equal(t_a, j_a)
    np.testing.assert_array_equal(t_w, j_w)
    np.testing.assert_array_equal(TEX.compute_image_id(elf),
                                  JEX.compute_image_id(elf))
    data = bytes(range(16)) if name == "echo_input" else b""
    t = TEX.Executor(elf, data, segment_po2=po2, trace=True).run()
    j = JEX.Executor(elf, data, segment_po2=po2, trace=True).run()
    for f in ("exit_code", "journal", "log", "user_cycles", "paging_cycles",
              "total_cycles", "keccak_calls", "bigint_calls", "sha_calls"):
        assert getattr(t, f) == getattr(j, f), f
    assert len(t.segments) == len(j.segments)
    if name == "spin" and args[0] > 5000:
        assert len(t.segments) > 1
    for ts, js in zip(t.segments, j.segments):
        for f in ("index", "user_cycles", "paging_cycles", "po2", "exit_pc",
                  "halted", "exit_code"):
            assert getattr(ts, f) == getattr(js, f), f
        for f in ("entry_regs", "exit_regs", "trace", "mem_addrs", "mem_pre",
                  "mem_post"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f),
                                          err_msg=f)
