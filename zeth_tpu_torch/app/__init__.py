"""zeth application layer: Ethereum stateless validation on the port,
jax-free copies of the JAX package's ``zeth_tpu.app`` modules.

- ``rlp``, ``trie``, ``state``: RLP and the sparse Merkle-Patricia trie
- ``chainspec``: hardfork tables
- ``txs``: transaction model, wire encoding and sender recovery
- ``evm``: ctypes driver of the native EVM engine (``csrc/evm.cpp``)
- ``bn254``, ``kzg``, ``bls12381``: the precompiles' curve arithmetic
- ``host``: the input model, block validation and ``BlockProcessor``
  (cache / validate / prove)
- ``guest_input``: guest ELF build and input serialization
- ``cli``: the end-user command line (``python -m zeth_tpu_torch.app.cli``)
- ``preflight``, ``rpc_proxy``: witness generation and the RPC proxy
- ``run_parallel``: the multi-block dev-mode pipeline
"""
