// Poseidon2 leaf sponge over the rows of a Baby Bear matrix (sm_90a).
//
// Replaces the TPU kernel zeth_tpu/pallas/poseidon2.py::_leaf_kernel
// (launched by _leaf_call, driven by hash_rows): for each row of an
// (R, C) Montgomery matrix, a width-24 Poseidon2 sponge with rate 16
// (ragged last chunk zero-padded; initial M_E, 4 external, 21 internal,
// 4 external rounds; S-box x^7) whose digest is the first 8 cells.
// Bit-identical to zeth_tpu_torch.hash.poseidon2.hash_rows. Any R >= 1,
// C >= 1 is taken. The TPU kernel's (8, 128) tiling, transposed staging
// and column-slab state carry exist for VMEM and lane layout; none of
// them is needed here.
//
// Bound: 32-bit integer instructions, not bytes. At the po2=20 rv32im
// main group (2^22 rows x 1009 columns) the matrix is read once (~16.9
// GB, 5 ms at 3.35 TB/s), but every row runs 64 permutations of 1,356
// Montgomery products and 2,368 modular additions each. So the kernel
// spends as few instructions as it can on a permutation, and keeps
// enough warps in flight to issue one every cycle. The field arithmetic
// is poseidon2.cuh's: a product in seven instructions (five dependent),
// an addition in two, every value below p. Of the card's two integer
// pipes the FMA pipe is the busier: it takes every multiply, and
// IMAD.WIDE.U32 and IMAD.HI.U32 hold it two cycles each (one a product
// of each), so a product costs it about six cycles, and ptxas puts some
// moves and additions there too (IMAD.MOV, IMAD.IADD). At the thread
// mapping's large shapes those FMA-pipe cycles, not issue, set the time
// (tools/torch_leaf_turns.py counts them; PERF.md).
//
// Three mappings of rows to lanes, one rule between them:
//  * 1 lane a row (row_kernel): the 24 cells in one thread's registers,
//    the fewest instructions a row. The cells of a round are unrolled,
//    the rounds are not: three loops (4 external, 21 internal, 4
//    external rounds), each round constant one indexed constant load
//    that the whole warp reads at one address (213 a permutation, ~1.5 %
//    of its 14,544 SASS instructions). Unrolled, a permutation is 14,362
//    instructions, ~230 KB of code, more than the SM's instruction
//    caches hold, and it ran 24 % slower at 2^22 x 1009 and 2.4x slower
//    at 16384 x 4161 (PERF.md). A warp holds 32 rows, so a matrix of few
//    rows leaves the card's schedulers without warps to switch between
//    and each waits on its own dependent instructions.
//  * 8 lanes a row (seg_kernel): lane q of a row's segment holds cells q,
//    q + 8 and q + 16, four rows a warp. M4 by xor shuffles inside each
//    aligned group of four lanes, the sum of a position over the six
//    blocks by one xor-4 shuffle, the internal rounds' sums by an xor 1,
//    2, 4 shuffle tree (shuffles never leave the segment, so rows do not
//    mix); every lane carries cell 0 through the internal rounds, as the
//    warp mapping does. Four times the warps of the thread mapping for
//    under twice its instructions a row.
//  * 32 lanes a row (poseidon2.cuh's warp_kernel, the sponge kernel's):
//    one cell a lane, the shortest chain a permutation.
// The rule (lanes_for), with SMs the card's SM count
// (cudaDevAttrMultiProcessorCount): 32 lanes a row up to WARP_MAX_PER_SM
// * SMs rows, 8 lanes up to SEG_MAX_PER_SM * SMs, one thread above. The
// thresholds are where the mappings' times cross in
// tools/torch_leaf_turns.py --sweep (every mapping from 1 to 512 rows an
// SM, densely and one row past each step near the switches, at 1009 and
// 84 columns; PERF.md). A warp a row is fastest up to 8 rows an SM, two
// blocks of four warps, two warps a scheduler; one row more puts a third
// block on an SM and 8 lanes win. 8 lanes win up to 96 rows an SM, six
// blocks of 16 rows; one row more puts a seventh on an SM, and one thread
// a row, flat at one warp's chain up to 128 rows an SM, wins.
// chip_smoke.py phase 3 times every mapping on either side of each switch.

#include "poseidon2.cuh"

namespace {

constexpr int THREADS = 128;               // a block, every mapping
// the rule's thresholds, in rows a streaming multiprocessor
constexpr int64_t WARP_MAX_PER_SM = 8;
constexpr int64_t SEG_MAX_PER_SM = 96;

// ---------------------------------------------------------------------------
// 1 lane a row
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t dbl(uint32_t x) { return add(x, x); }

// M_E = circ(2*M4, M4, ...) on a thread's 24 cells: M4 on each block of
// four by the Poseidon2 paper's chain of additions, then each cell adds
// the sum of its position over the six blocks.
__device__ __forceinline__ void row_external_layer(uint32_t (&s)[CELLS]) {
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
  for (int j = 0; j < 4; ++j)
    sum[j] = add(add(add(s[j], s[4 + j]), add(s[8 + j], s[12 + j])),
                 add(s[16 + j], s[20 + j]));
#pragma unroll
  for (int i = 0; i < CELLS; ++i) s[i] = add(s[i], sum[i % 4]);
}

__device__ __forceinline__ void row_external_round(uint32_t (&s)[CELLS],
                                                   int r) {
#pragma unroll
  for (int i = 0; i < CELLS; ++i)
    s[i] = sbox(add(s[i], c_rc_ext[r * CELLS + i]));
  row_external_layer(s);
}

// M_I = J + diag(diag_m1): every cell becomes the sum of all cells (a tree
// of additions) plus its diagonal entry times itself.
__device__ __forceinline__ void row_internal_round(uint32_t (&s)[CELLS],
                                                   int r) {
  s[0] = sbox(add(s[0], c_rc_int[r]));
  uint32_t t[CELLS / 2];
#pragma unroll
  for (int i = 0; i < CELLS / 2; ++i) t[i] = add(s[2 * i], s[2 * i + 1]);
#pragma unroll
  for (int i = 0; i < CELLS / 4; ++i) t[i] = add(t[2 * i], t[2 * i + 1]);
#pragma unroll
  for (int i = 0; i < CELLS / 8; ++i) t[i] = add(t[2 * i], t[2 * i + 1]);
  uint32_t sum = add(add(t[0], t[1]), t[2]);
#pragma unroll
  for (int i = 0; i < CELLS; ++i) s[i] = add(sum, mul(s[i], c_diag_m1[i]));
}

__device__ __forceinline__ void row_permute(uint32_t (&s)[CELLS]) {
  row_external_layer(s);
#pragma unroll 1
  for (int r = 0; r < ROUNDS_FULL / 2; ++r) row_external_round(s, r);
#pragma unroll 1
  for (int r = 0; r < ROUNDS_PARTIAL; ++r) row_internal_round(s, r);
#pragma unroll 1
  for (int r = ROUNDS_FULL / 2; r < ROUNDS_FULL; ++r) row_external_round(s, r);
}

__global__ void __launch_bounds__(THREADS)
row_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
           int64_t rows, int64_t cols) {
  int64_t row = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (row >= rows) return;
  const uint32_t* src = in + row * cols;
  uint32_t s[CELLS];
#pragma unroll
  for (int i = 0; i < CELLS; ++i) s[i] = 0u;
  const int64_t chunks = cols > 0 ? (cols + RATE - 1) / RATE : 1;
  for (int64_t k = 0; k < chunks; ++k) {   // one permutation in the code
    const int64_t off = k * RATE;
    if (off + RATE <= cols) {
#pragma unroll
      for (int j = 0; j < RATE; ++j) s[j] = add(s[j], __ldg(src + off + j));
    } else {                               // ragged tail, zero-padded
#pragma unroll
      for (int j = 0; j < RATE; ++j)
        if (off + j < cols) s[j] = add(s[j], __ldg(src + off + j));
    }
    row_permute(s);
  }
  uint32_t* dst = out + row * DIGEST;
#pragma unroll
  for (int j = 0; j < DIGEST; ++j) dst[j] = s[j];
}

// ---------------------------------------------------------------------------
// 8 lanes a row
// ---------------------------------------------------------------------------

constexpr int SEG = 8;                     // lanes a row
constexpr int SLOTS = CELLS / SEG;         // cells a lane: q, q + 8, q + 16
constexpr int SEG_ROWS = THREADS / SEG;    // rows a block

struct Seg {
  uint32_t rc[ROUNDS_FULL][SLOTS];  // the external round constants of its cells
  uint32_t dm[SLOTS];         // diag_m1 of its cells; 0 for cell 0
  uint32_t d0;                // diag_m1 of cell 0
  uint32_t mu0;               // d0 + 1, cell 0's diagonal entry of M_I
  M4Row m4;                   // its position's row of M4
  bool first;                 // q == 0: slot 0 is cell 0
};

__device__ __forceinline__ Seg seg_setup(int q) {
  Seg S;
#pragma unroll
  for (int r = 0; r < ROUNDS_FULL; ++r)
#pragma unroll
    for (int k = 0; k < SLOTS; ++k)
      S.rc[r][k] = c_rc_ext[r * CELLS + SEG * k + q];
  S.first = q == 0;
#pragma unroll
  for (int k = 0; k < SLOTS; ++k)
    S.dm[k] = (k == 0 && S.first) ? 0u : c_diag_m1[SEG * k + q];
  S.d0 = c_diag_m1[0];
  S.mu0 = add(S.d0, MONT_ONE);
  S.m4 = m4_row(q);                        // cell q + 8k is at position q % 4
  return S;
}

// The sum mod p over the calling lane's segment of v (< p): xor 1, 2, 4
// never leave an aligned group of eight lanes.
__device__ __forceinline__ uint32_t seg_sum(uint32_t v) {
  v = add(v, __shfl_xor_sync(FULL, v, 1));
  v = add(v, __shfl_xor_sync(FULL, v, 2));
  return add(v, __shfl_xor_sync(FULL, v, 4));
}

// M_E: slot k of lanes 0-3 is block 2k, of lanes 4-7 block 2k + 1, at
// position q % 4. M4 by xor 1, 2, 3; a position's sum over the three
// blocks of a half is local, over the other half one xor-4 shuffle.
__device__ __forceinline__ void seg_external_layer(uint32_t (&x)[SLOTS],
                                                   const Seg& S) {
  uint32_t z[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k)
    z[k] = m4_dot(x[k], __shfl_xor_sync(FULL, x[k], 1),
                  __shfl_xor_sync(FULL, x[k], 2),
                  __shfl_xor_sync(FULL, x[k], 3), S.m4);
  uint32_t t = add(add(z[0], z[1]), z[2]);
  t = add(t, __shfl_xor_sync(FULL, t, 4));
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) x[k] = add(z[k], t);
}

template <int R>
__device__ __forceinline__ void seg_external_round(uint32_t (&x)[SLOTS],
                                                   const Seg& S) {
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) x[k] = sbox(add(x[k], S.rc[R][k]));
  seg_external_layer(x, S);
}

template <int R, int END>
__device__ __forceinline__ void seg_external_rounds(uint32_t (&x)[SLOTS],
                                                    const Seg& S) {
  if constexpr (R < END) {
    seg_external_round<R>(x, S);
    seg_external_rounds<R + 1, END>(x, S);
  }
}

// The internal rounds as warp_internal_rounds runs them: every lane
// carries y = cell 0 + the round's constant and part = the sum of cells
// 1..23, and its own cells in x (slot 0 of lane 0, cell 0, unread: its
// dm is 0). The next y is (part + rc) + mu0 sb; the next part is
// 23 (part + sb) + sum_{i>=1} d_i x_i, the segment's sum of each lane's
// three products.
template <int R>
__device__ __forceinline__ void seg_internal_from(uint32_t& y, uint32_t& part,
                                                  uint32_t (&x)[SLOTS],
                                                  const Seg& S) {
  if constexpr (R < ROUNDS_PARTIAL - 1) {
    uint32_t sb = sbox(y);
    uint32_t w[SLOTS];
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) w[k] = mul(x[k], S.dm[k]);
    uint32_t sum = add(part, sb);          // sum of all cells after the S-box
    y = add(add(part, c_rc_int[R + 1]), mul(sb, S.mu0));
    part = add(mul(sum, MONT_23), seg_sum(add(add(w[0], w[1]), w[2])));
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) x[k] = add(sum, w[k]);
    seg_internal_from<R + 1>(y, part, x, S);
  }
}

__device__ __forceinline__ void seg_internal_rounds(uint32_t (&x)[SLOTS],
                                                    const Seg& S) {
  uint32_t y = add(__shfl_sync(FULL, x[0], 0, SEG), c_rc_int[0]);
  uint32_t part = seg_sum(add(add(S.first ? 0u : x[0], x[1]), x[2]));
  seg_internal_from<0>(y, part, x, S);
  uint32_t sb = sbox(y);                   // the last round
  uint32_t sum = add(part, sb);
  uint32_t c0 = add(sum, mul(sb, S.d0));
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) x[k] = add(sum, mul(x[k], S.dm[k]));
  if (S.first) x[0] = c0;
}

__device__ __forceinline__ void seg_permute(uint32_t (&x)[SLOTS],
                                            const Seg& S) {
  seg_external_layer(x, S);
  seg_external_rounds<0, ROUNDS_FULL / 2>(x, S);
  seg_internal_rounds(x, S);
  seg_external_rounds<ROUNDS_FULL / 2, ROUNDS_FULL>(x, S);
}

__global__ void __launch_bounds__(THREADS)
seg_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
           int64_t rows, int64_t cols) {
  const int q = threadIdx.x & (SEG - 1);
  const int64_t first_row = static_cast<int64_t>(blockIdx.x) * SEG_ROWS +
                            (threadIdx.x & ~31) / SEG;
  if (first_row >= rows) return;           // the whole warp
  const int64_t row = static_cast<int64_t>(blockIdx.x) * SEG_ROWS +
                      threadIdx.x / SEG;
  // a segment past the last row hashes the last row again, so that every
  // lane of the warp takes part in the shuffles; it stores nothing
  const uint32_t* src = in + (row < rows ? row : rows - 1) * cols;
  const Seg S = seg_setup(q);
  const int64_t chunks = cols > 0 ? (cols + RATE - 1) / RATE : 1;
  auto load = [&](int64_t k, int half) -> uint32_t {
    int64_t j = k * RATE + SEG * half + q;
    return j < cols ? __ldg(src + j) : 0u;
  };
  uint32_t x[SLOTS] = {0u, 0u, 0u};
  uint32_t cur0 = load(0, 0), cur1 = load(0, 1);
  for (int64_t k = 0; k < chunks; ++k) {
    uint32_t next0 = k + 1 < chunks ? load(k + 1, 0) : 0u;
    uint32_t next1 = k + 1 < chunks ? load(k + 1, 1) : 0u;
    x[0] = add(x[0], cur0);                // cells q and q + 8 of the rate
    x[1] = add(x[1], cur1);
    seg_permute(x, S);
    cur0 = next0;
    cur1 = next1;
  }
  if (row < rows) out[row * DIGEST + q] = x[0];
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The mapping the rule picks for `rows` on a card of `sms` SMs.
int lanes_for(int64_t rows, int sms) {
  if (rows <= WARP_MAX_PER_SM * sms) return 32;
  if (rows <= SEG_MAX_PER_SM * sms) return SEG;
  return 1;
}

// The current device's SM count, read once a device.
int current_sms() {
  constexpr int MAX_DEVICES = 64;
  static int sms[MAX_DEVICES] = {};
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < MAX_DEVICES && sms[dev] > 0) return sms[dev];
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev >= 0 && dev < MAX_DEVICES) sms[dev] = n;
  return n;
}

int launch(const void* in, void* out, int64_t rows, int64_t cols, int lanes,
           cudaStream_t stream) {
  const auto* src = static_cast<const uint32_t*>(in);
  auto* dst = static_cast<uint32_t*>(out);
  if (lanes == 1) {
    int64_t blocks = (rows + THREADS - 1) / THREADS;
    row_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        src, dst, rows, cols);
  } else if (lanes == SEG) {
    int64_t blocks = (rows + SEG_ROWS - 1) / SEG_ROWS;
    seg_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        src, dst, rows, cols);
  } else if (lanes == 32) {
    return launch_warp_kernel(in, out, rows, cols, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Host pointers to the Montgomery tables: rc_ext (8*24), rc_int (21),
// diag_m1 (24). Returns a cudaError_t.
int poseidon2_leaf_set_constants(const uint32_t* rc_ext,
                                 const uint32_t* rc_int,
                                 const uint32_t* diag_m1) {
  return upload_constants(rc_ext, rc_int, diag_m1);
}

// The lanes a row (1, 8 or 32) that poseidon2_leaf takes for `rows` on
// the current device.
int poseidon2_leaf_mapping(int64_t rows) {
  return lanes_for(rows, current_sms());
}

// in: (rows, cols) row-major Montgomery matrix on the device; out:
// (rows, 8) digests. Launches on `stream` with the mapping the rule picks;
// does not synchronise. Returns cudaGetLastError() after the launch.
int poseidon2_leaf(const void* in, void* out, int64_t rows, int64_t cols,
                   void* stream) {
  if (rows <= 0) return 0;
  return launch(in, out, rows, cols, lanes_for(rows, current_sms()),
                static_cast<cudaStream_t>(stream));
}

// As poseidon2_leaf, with the mapping given: `lanes` a row, 1, 8 or 32
// (anything else returns cudaErrorInvalidValue and launches nothing).
int poseidon2_leaf_lanes(const void* in, void* out, int64_t rows,
                         int64_t cols, int lanes, void* stream) {
  if (rows <= 0) return 0;
  return launch(in, out, rows, cols, lanes,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
