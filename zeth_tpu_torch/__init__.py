"""zeth-tpu on PyTorch: the STARK prove stack for one NVIDIA H100.

A second package beside ``zeth_tpu`` (the JAX reference). It mirrors the
reference's module names, so each module's counterpart is easy to find:

- ``field``, ``ntt``         Baby Bear + ext4 arithmetic and NTT/LDE on
                             torch int32 tensors (Montgomery form)
- ``hash``                   Poseidon2, Merkle trees, the page tree
- ``kernels``                hand-written CUDA kernels and their build
- ``zkp``                    DEEP-ALI + FRI prover (device) and verifier
                             (host numpy)
- ``circuits``               rv32im, paging, keccak, bigint2, sha256 and
                             toy AIRs (host copies), the segment prover
                             and the chain verifier
- ``zkvm``                   the host API: executor env, LocalProver,
                             receipts and their verification
- ``executor``               the C++ RV32IM emulator and its guests (copy)
- ``app``, ``cc``, ``guest`` the stateless-client guest's front end: input
                             model and encoder, the C compiler, the guest's
                             C sources (copies)
- ``parallel``               the multi-device path: torch.distributed
                             bring-up, the distributed four-step NTT and
                             LDE, sharded Merkle commits, collectives
- ``convert``                numpy uint32 <-> int32 tensor conversion

The port imports ``torch`` and never ``jax``, and nothing of the reference
package: the host code it needs (the C++ executor included) is carried as
jax-free copies, which the tests hold equal to the reference's.

Field elements are ``torch.int32`` tensors (p = 2013265921 < 2^31) in
Montgomery form with R = 2^32, so every intermediate array equals the
reference's uint32 array bit for bit. Products are formed in int64. Every
device function takes its tensors' device. The entry points (``prove``,
``commit_main``, ``prove_segments``, ``prove_segment``, ``prove_batch``,
the verifiers, ``zkvm.LocalProver``, ``Transcript.grind``,
``convert.to_tensor``) run on the CUDA card unless the caller passes a
device, and raise where there is no card (``convert.resolve_device``).
"""

__version__ = "0.1.0"


# glibc hands every numpy buffer over 128 KiB to its own mmap/munmap, and
# its dynamic threshold climbs no higher than 32 MiB, so each large witgen
# or aux buffer pays page faults anew; the reference measured its host
# stages 10-50x slower than their arithmetic that way. Keep blocks under
# 1 GiB on the heap's free list, and trim its top only past 256 MiB, so
# repeated prove calls reuse warm pages. The options are per process and
# reach the main arena: a worker thread's arena still mmaps any block over
# its 64 MiB heap.
def _tune_malloc():
    import ctypes
    import sys
    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(-3, 1 << 30)    # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 28)    # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_malloc()
del _tune_malloc
