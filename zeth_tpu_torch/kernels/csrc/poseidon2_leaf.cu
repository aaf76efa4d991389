// Poseidon2 leaf sponge over the rows of a Baby Bear matrix (sm_90a).
//
// Replaces the TPU kernel zeth_tpu/pallas/poseidon2.py::_leaf_kernel
// (launched by _leaf_call, driven by hash_rows): for each row of an
// (R, C) Montgomery matrix, a width-24 Poseidon2 sponge with rate 16
// (ragged last chunk zero-padded; initial M_E, 4 external, 21 internal,
// 4 external rounds; S-box x^7) whose digest is the first 8 cells.
// Bit-identical to zeth_tpu_torch.hash.poseidon2.hash_rows.
//
// Design: one thread per row, the 24 state cells in registers. The
// thread reads its row straight from the row-major int32 matrix, one
// 16-column chunk at a time, and writes 8 digest words to the (R, 8)
// output. Round constants sit in __constant__ memory: every thread of a
// warp reads the same constant at the same time, which constant memory
// broadcasts. The TPU kernel's (8, 128) tiling, transposed staging and
// column-slab state carry exist for VMEM and lane layout; none of them
// is needed here, and any R >= 1, C >= 1 is taken.
//
// Bound: 32-bit integer multiplies, not bytes. At the po2=20 rv32im main
// group (2^22 rows x 1009 columns) the matrix is read once (~16.9 GB),
// but every row runs 64 permutations of ~1,350 Montgomery products each
// (8 external rounds x 24 S-boxes x 4, plus 21 internal rounds x (4 + 24)).
// The row-per-thread reads are not coalesced (neighbouring threads are
// C words apart); staging tiles through shared memory so that a warp
// reads contiguous bytes is later work, as is spreading one row's
// permutation over several threads to raise occupancy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P = 2013265921u;        // 15 * 2^27 + 1
constexpr uint32_t NPRIME = 2013265919u;   // -p^-1 mod 2^32
constexpr int CELLS = 24;
constexpr int RATE = 16;
constexpr int DIGEST = 8;
constexpr int ROUNDS_FULL = 8;
constexpr int ROUNDS_PARTIAL = 21;

__constant__ uint32_t c_rc_ext[ROUNDS_FULL * CELLS];  // Montgomery
__constant__ uint32_t c_rc_int[ROUNDS_PARTIAL];       // Montgomery
__constant__ uint32_t c_diag_m1[CELLS];               // Montgomery

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t s = a + b;                      // < 2p < 2^32
  return s >= P ? s - P : s;
}

// Montgomery product a * b * 2^-32 mod p (REDC, as zeth_tpu.field.mul).
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  uint64_t t = static_cast<uint64_t>(a) * b;
  uint32_t lo = static_cast<uint32_t>(t);
  uint32_t hi = static_cast<uint32_t>(t >> 32);
  uint32_t m = lo * NPRIME;                // mod 2^32
  // lo + lo(m * p) is 0 when lo == 0, else exactly 2^32
  uint32_t r = hi + __umulhi(m, P) + (lo != 0u);   // < 2p
  return r >= P ? r - P : r;
}

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  uint32_t x2 = mul(x, x);
  uint32_t x4 = mul(x2, x2);
  return mul(mul(x4, x2), x);
}

__device__ __forceinline__ uint32_t dbl(uint32_t x) { return add(x, x); }

// M_E = circ(2*M4, M4, ...): the public M4 on each 4-cell block, then
// each cell adds the sum of its position over all blocks.
__device__ __forceinline__ void external_layer(uint32_t (&s)[CELLS]) {
#pragma unroll
  for (int b = 0; b < CELLS / 4; ++b) {
    uint32_t x0 = s[4 * b], x1 = s[4 * b + 1];
    uint32_t x2 = s[4 * b + 2], x3 = s[4 * b + 3];
    uint32_t t0 = add(x0, x1);
    uint32_t t1 = add(x2, x3);
    uint32_t t2 = add(dbl(x1), t1);
    uint32_t t3 = add(dbl(x3), t0);
    uint32_t t4 = add(dbl(dbl(t1)), t3);
    uint32_t t5 = add(dbl(dbl(t0)), t2);
    s[4 * b] = add(t3, t5);
    s[4 * b + 1] = t5;
    s[4 * b + 2] = add(t2, t4);
    s[4 * b + 3] = t4;
  }
  uint32_t sum[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sum[j] = s[j];
#pragma unroll
    for (int b = 1; b < CELLS / 4; ++b) sum[j] = add(sum[j], s[4 * b + j]);
  }
#pragma unroll
  for (int i = 0; i < CELLS; ++i) s[i] = add(s[i], sum[i % 4]);
}

__device__ __forceinline__ void external_round(uint32_t (&s)[CELLS], int r) {
#pragma unroll
  for (int i = 0; i < CELLS; ++i) s[i] = sbox(add(s[i], c_rc_ext[r * CELLS + i]));
  external_layer(s);
}

__device__ __forceinline__ void internal_round(uint32_t (&s)[CELLS], int r) {
  s[0] = sbox(add(s[0], c_rc_int[r]));
  uint32_t sum = s[0];
#pragma unroll
  for (int i = 1; i < CELLS; ++i) sum = add(sum, s[i]);
#pragma unroll
  for (int i = 0; i < CELLS; ++i) s[i] = add(sum, mul(s[i], c_diag_m1[i]));
}

__device__ void permute(uint32_t (&s)[CELLS]) {
  external_layer(s);
#pragma unroll 1
  for (int r = 0; r < ROUNDS_FULL / 2; ++r) external_round(s, r);
#pragma unroll 1
  for (int r = 0; r < ROUNDS_PARTIAL; ++r) internal_round(s, r);
#pragma unroll 1
  for (int r = ROUNDS_FULL / 2; r < ROUNDS_FULL; ++r) external_round(s, r);
}

__global__ void __launch_bounds__(128)
leaf_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
            int64_t rows, int64_t cols) {
  int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const uint32_t* src = in + row * cols;
  uint32_t s[CELLS];
#pragma unroll
  for (int i = 0; i < CELLS; ++i) s[i] = 0u;
  int64_t off = 0;
  for (; off + RATE <= cols; off += RATE) {
#pragma unroll
    for (int j = 0; j < RATE; ++j) s[j] = add(s[j], __ldg(src + off + j));
    permute(s);
  }
  if (off < cols || cols == 0) {           // ragged tail, zero-padded
#pragma unroll
    for (int j = 0; j < RATE; ++j)
      if (off + j < cols) s[j] = add(s[j], __ldg(src + off + j));
    permute(s);
  }
  uint32_t* dst = out + row * DIGEST;
#pragma unroll
  for (int j = 0; j < DIGEST; ++j) dst[j] = s[j];
}

}  // namespace

extern "C" {

// Host pointers to the Montgomery tables: rc_ext (8*24), rc_int (21),
// diag_m1 (24). Returns a cudaError_t.
int poseidon2_leaf_set_constants(const uint32_t* rc_ext,
                                 const uint32_t* rc_int,
                                 const uint32_t* diag_m1) {
  cudaMemcpyToSymbol(c_rc_ext, rc_ext, sizeof(uint32_t) * ROUNDS_FULL * CELLS);
  cudaMemcpyToSymbol(c_rc_int, rc_int, sizeof(uint32_t) * ROUNDS_PARTIAL);
  cudaMemcpyToSymbol(c_diag_m1, diag_m1, sizeof(uint32_t) * CELLS);
  return static_cast<int>(cudaGetLastError());
}

// in: (rows, cols) row-major Montgomery matrix on the device; out:
// (rows, 8) digests. Launches on `stream`; does not synchronise.
// Returns cudaGetLastError() after the launch.
int poseidon2_leaf(const void* in, void* out, int64_t rows, int64_t cols,
                   void* stream) {
  if (rows <= 0) return 0;
  constexpr int threads = 128;
  int64_t blocks = (rows + threads - 1) / threads;
  leaf_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), rows,
      cols);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
