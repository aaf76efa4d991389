"""zeth application layer, as far as the stateless-client guest's input
needs it: jax-free copies of the JAX package's ``zeth_tpu.app`` modules.

- ``rlp``, ``trie``, ``state``: RLP and the sparse Merkle-Patricia trie
- ``chainspec``: hardfork tables
- ``txs``: transaction model and wire encoding
- ``host``: the ``StatelessInput`` model and its JSON reader
- ``kzg``, ``bls12381``: the KZG ceremony point hashed into the guest image
- ``guest_input``: guest ELF build and input serialization

The native EVM interpreter, block validation, RPC and the CLI are not
carried yet.
"""
