// Witness staging kernels (ctypes shared library).
//
// The prover ships the main trace group to the device as packed bit
// words + uint32 value columns (zeth_tpu/zkp/prover.py _upload_main).
// Doing the bit-gather in numpy costs ~1.7 s per po2=18 segment on this
// 4-vCPU host (strided ORs over a 2 GB matrix); this row-major C loop
// touches each 8 KB witness row once while it is L1-resident. Callers
// split the row range across Python threads (ctypes releases the GIL).

#include <cstdint>

extern "C" {

// m: (n, C) uint64 row-major standard-form witness rows.
// bit_cols[k]: source column of packed bit k (k < n_bits);
// val_cols[k]: source column of value k (k < n_vals).
// packed: (n, n_words) uint32; vals: (n, n_vals) uint32. Rows [r0, r1).
void zeth_pack_rows(const uint64_t* m, int64_t C,
                    const int32_t* bit_cols, int64_t n_bits,
                    const int32_t* val_cols, int64_t n_vals,
                    uint32_t* packed, int64_t n_words,
                    uint32_t* vals, int64_t r0, int64_t r1) {
  for (int64_t r = r0; r < r1; ++r) {
    const uint64_t* row = m + r * C;
    uint32_t* prow = packed + r * n_words;
    for (int64_t w = 0; w < n_words; ++w) prow[w] = 0;
    for (int64_t k = 0; k < n_bits; ++k)
      prow[k >> 5] |= (uint32_t)(row[bit_cols[k]] & 1u) << (k & 31);
    uint32_t* vrow = vals + r * n_vals;
    for (int64_t k = 0; k < n_vals; ++k)
      vrow[k] = (uint32_t)row[val_cols[k]];
  }
}

}  // extern "C"
