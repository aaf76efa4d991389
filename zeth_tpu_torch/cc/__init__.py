"""zeth-cc: a small C compiler targeting the RV32IM zkVM guest.

Fills the role of the reference's guest build toolchain
(SURVEY.md §2.1 `guests` build crate + the Rust->RV32IM cross compiler,
guests/build.rs:18-55): this environment has no RISC-V cross-toolchain,
so guest programs (including the stateless-client, SURVEY.md §2.1
guests/stateless-client/src/lib.rs:21-34) are written in C99 and
compiled in-tree to RV32IM ELFs for the C++ executor.

Pipeline: gcc -E (preprocess only) -> pycparser AST -> codegen
(zeth_tpu_torch.cc.compiler) -> zeth_tpu_torch.executor.assembler words ->
zeth_tpu_torch.executor.elf.write_elf.
"""

from .compiler import CompileError, compile_c  # noqa: F401
