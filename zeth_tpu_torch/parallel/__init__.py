"""The multi-device path: distributed NTT, sharded commits, process meshes.

Counterpart of ``zeth_tpu.parallel``. The reference is single-controller:
one JAX process holds global arrays over a ``Mesh`` and GSPMD inserts the
collectives. PyTorch is SPMD instead: one process per rank, a 1-D
``DeviceMesh`` with a ``rows`` dimension, and explicit collectives from
``torch.distributed`` (``comm``). Trace rows are sharded in contiguous
blocks over the ranks; the NTT is Bailey's four-step with all_to_all
exchanges; Merkle subtree roots merge with an all_gather.
"""

from .dist_ntt import dist_ntt, dist_intt, dist_coset_lde  # noqa: F401
from .commit import sharded_commit_root  # noqa: F401
from .multihost import init as init_distributed, local_mesh, pod_mesh, \
    shard_work  # noqa: F401
