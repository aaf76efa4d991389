// Poseidon2 sponge of each row of a Baby Bear matrix, one warp per row
// (sm_90a).
//
// Computes what poseidon2_leaf.cu computes, bit for bit: for each row of
// an (R, C) Montgomery matrix, a width-24 Poseidon2 sponge with rate 16
// (ragged last chunk zero-padded; initial M_E, 4 external, 21 internal,
// 4 external rounds; S-box x^7) whose digest is the first 8 cells. Its
// plain version is zeth_tpu_torch.hash.poseidon2.hash_rows; its wrapper
// is sponge_hash, which sponge_row calls for the claims and publics
// digests.
//
// It replaces no TPU kernel. The JAX package computes these digests on
// the host (zeth_tpu/circuits/bigint2.py:359 and
// zeth_tpu/recursion/compiler.py:473 call hash_rows_np). It is the
// one-row form of the leaf sponge, the function of
// zeth_tpu/pallas/poseidon2.py:110, added because one thread a row leaves
// a one-row launch bound by latency: one thread runs every cell of every
// round, one permutation after another.
//
// Bound: a row is a chain of permutations, each waiting on the last, so a
// one-row launch is bound by the critical path of one permutation times
// their number, not by bytes or by the card's integer rate. The design
// (poseidon2.cuh: warp_kernel, warp_permute) shortens that path: one cell
// a lane, the external layer in two dependent shuffles, every lane
// carrying cell 0 through the unrolled internal rounds with the warp sums
// off its chain, Montgomery products of five dependent instructions,
// x^7 = x^4 * x^3, and the next chunk loaded one permutation ahead. The
// leaf kernel (poseidon2_leaf.cu) launches the same warp kernel for its
// 32-lane mapping.

#include "poseidon2.cuh"

extern "C" {

// Host pointers to the Montgomery tables: rc_ext (8*24), rc_int (21),
// diag_m1 (24). Returns a cudaError_t.
int poseidon2_sponge_set_constants(const uint32_t* rc_ext,
                                   const uint32_t* rc_int,
                                   const uint32_t* diag_m1) {
  return upload_constants(rc_ext, rc_int, diag_m1);
}

// in: (rows, cols) row-major Montgomery matrix on the device; out:
// (rows, 8) digests. Launches on `stream`; does not synchronise.
// Returns cudaGetLastError() after the launch.
int poseidon2_sponge(const void* in, void* out, int64_t rows, int64_t cols,
                     void* stream) {
  if (rows <= 0) return 0;
  return launch_warp_kernel(in, out, rows, cols,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
