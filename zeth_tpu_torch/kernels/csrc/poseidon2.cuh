// Poseidon2 over Baby Bear (width 24, rate 16, S-box x^7) for the CUDA
// kernels of this directory (sm_90a): the field arithmetic, the round
// constants and their upload, and the permutation as one warp computes it
// with one cell a lane, with the sponge of one row built on it. Included
// by poseidon2_leaf.cu and poseidon2_sponge.cu, which are built into
// libraries of their own: each has its own copy of the constant tables
// and uploads them itself (upload_constants).
//
// Every value stays canonical (< p): add and mul take operands below p
// and return a value below p. The order of the additions then does not
// change the result, and mul's 64-bit sum cannot overflow (see mul).
//
// The warp's permutation (warp_permute; the sponge kernel's design,
// which the leaf kernel's 32-lane mapping shares):
//  * Lanes. Lane i < 24 holds cell i. Lanes 24-31 hold 0 and keep it: no
//    round constant is added there, and S-box(0) = 0. The 24 S-boxes of an
//    external round run side by side.
//  * Constants in registers. Each lane loads its 8 external round
//    constants and its diagonal entry once. (Constant memory broadcasts
//    one address to a warp; 24 addresses would be read one after another.)
//  * External layer: two dependent shuffles. M4 on each block of four
//    lanes through __shfl_xor_sync (xor 1, 2, 3) and one 64-bit dot
//    product; then each lane reads the same position of the five other
//    blocks (five index shuffles side by side) and adds. A shuffle's wait
//    is long against an addition, so this beats the xor 4, 8, 16
//    butterfly, which waits on three shuffles in a row.
//  * Internal rounds. Every lane carries cell 0 and runs its S-box
//    itself, so nothing waits on a broadcast. The sum that round r + 1
//    needs is 23 * sum_r + sum_{i>=1} d_i * x_i, whose products exist
//    when round r starts: the warp reduces them (redux.sync) while cell
//    0's S-box runs, so cell 0's chain (S-box, product, add) sets the
//    pace. The rounds are unrolled, so the compiler can lay a round's
//    reduction beside the next round's S-box: a warp issues in order.
//  * Montgomery products of five dependent instructions (see mul), and
//    S-box x^7 = x^4 * x^3: three dependent products, not four.
//  * Loads. Lanes 0-15 load the next 16-word chunk (one 64-byte read) one
//    permutation ahead, so its latency hides behind the permutation.

#pragma once

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
constexpr int WARPS = 4;                   // warps a block of the warp kernel
constexpr unsigned FULL = 0xffffffffu;
// Montgomery forms: mul(x, MONT_23) = 23 x, mul(x, MONT_2_48) = 2^16 x
constexpr uint32_t MONT_ONE =
    static_cast<uint32_t>((static_cast<uint64_t>(1) << 32) % P);
constexpr uint32_t MONT_23 =
    static_cast<uint32_t>((static_cast<uint64_t>(23) << 32) % P);
constexpr uint32_t MONT_2_48 =
    static_cast<uint32_t>((static_cast<uint64_t>(1) << 48) % P);

__constant__ uint32_t c_rc_ext[ROUNDS_FULL * CELLS];  // Montgomery
__constant__ uint32_t c_rc_int[ROUNDS_PARTIAL];       // Montgomery
__constant__ uint32_t c_diag_m1[CELLS];               // Montgomery

// Host pointers to the Montgomery tables: rc_ext (8*24), rc_int (21),
// diag_m1 (24). Returns a cudaError_t.
int upload_constants(const uint32_t* rc_ext, const uint32_t* rc_int,
                     const uint32_t* diag_m1) {
  cudaMemcpyToSymbol(c_rc_ext, rc_ext, sizeof(uint32_t) * ROUNDS_FULL * CELLS);
  cudaMemcpyToSymbol(c_rc_int, rc_int, sizeof(uint32_t) * ROUNDS_PARTIAL);
  cudaMemcpyToSymbol(c_diag_m1, diag_m1, sizeof(uint32_t) * CELLS);
  return static_cast<int>(cudaGetLastError());
}

// a + b mod p for a, b < p: s - P wraps above s exactly when s < p.
// Two instructions (IADD3, VIADDMNMX).
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t s = a + b;                      // < 2p < 2^32
  return min(s, s - P);
}

// a * b + c, 32 x 32 -> 64 bits (one IMAD.WIDE.U32)
__device__ __forceinline__ uint64_t madw(uint32_t a, uint32_t b, uint64_t c) {
  uint64_t d;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// Montgomery product a * b * 2^-32 mod p (REDC, as zeth_tpu.field.mul):
// t + m p is a multiple of 2^32 below 2^62 + 2^63 (a b < p^2 < 2^62, so
// both operands must be below p), so its high word is REDC(t) < 2p. ptxas
// folds lo(m p) to -lo(t) and forms the carry of lo(t) + lo(m p) beside
// the chain: seven instructions, five of them dependent (IMAD.WIDE.U32,
// IMAD, IMAD.HI.U32, IMAD.X, VIADDMNMX). The carry-free form with +p^-1,
// hi(t) - umulhi(m, p) + p, is five in all and made the thread mapping
// 15 % faster at 2^22 x 1009, but ptxas schedules the warp permutation
// with it into longer stalls, and one row on 32 lanes ran 35 % slower
// (PERF.md); one form serves every mapping.
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  uint64_t t = madw(a, b, 0);
  uint32_t m = static_cast<uint32_t>(t) * NPRIME;   // mod 2^32
  uint32_t r = static_cast<uint32_t>(madw(m, P, t) >> 32);
  return min(r, r - P);
}

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  uint32_t x2 = mul(x, x);
  return mul(mul(x2, x2), mul(x2, x));
}

// v mod p for v < 2^35: 2^31 = p + 2^27 - 1, so v = h 2^31 + l is
// h (2^27 - 1) + l < 2^32 mod p, which two conditional subtractions bring
// below p.
__device__ __forceinline__ uint32_t reduce35(uint64_t v) {
  uint32_t h = static_cast<uint32_t>(v >> 31);          // < 16
  uint32_t r = h * ((1u << 27) - 1u) +
               (static_cast<uint32_t>(v) & 0x7fffffffu);
  r = min(r, r - P);
  return min(r, r - P);
}

// M4's row for a lane at position j of its block of four, against (x,
// a1, a2, a3) where a_m is the value at position j ^ m: (5, 7, 1, 3) at
// an even position, (6, 4, 1, 1) at an odd one (the public M4,
// zeth_tpu_torch.hash.poseidon2._M4).
struct M4Row {
  uint32_t k0, k1, k3;
};

__device__ __forceinline__ M4Row m4_row(int position) {
  const bool even = (position & 1) == 0;
  return {even ? 5u : 6u, even ? 7u : 4u, even ? 3u : 1u};
}

// The lane's cell of M4 on its block (x, a1, a2, a3 < p: the dot product
// is below 16p).
__device__ __forceinline__ uint32_t m4_dot(uint32_t x, uint32_t a1,
                                           uint32_t a2, uint32_t a3,
                                           const M4Row& k) {
  return reduce35(madw(x, k.k0, madw(a1, k.k1, madw(a3, k.k3, a2))));
}

// Every lane gets the sum mod p over the warp of v (< p on every lane):
// redux.sync adds 32-bit words, so the 16-bit halves are summed apart
// (each sum < 2^21) and joined as hi 2^16 + lo.
__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  uint32_t lo = __reduce_add_sync(FULL, v & 0xffffu);
  uint32_t hi = __reduce_add_sync(FULL, v >> 16);
  return add(mul(hi, MONT_2_48), lo);
}

struct Lane {
  uint32_t rc[ROUNDS_FULL];   // this cell's external round constants
  uint32_t dm;                // diag_m1 of this cell; 0 on lanes 0, >= 24
  uint32_t d0;                // diag_m1 of cell 0
  uint32_t mu0;               // d0 + 1, cell 0's diagonal entry of M_I
  int src[5];                 // the same position in the other blocks
  bool live;                  // lane < 24
  bool first;                 // lane == 0
  M4Row m4;                   // this cell's row of M4
};

__device__ __forceinline__ Lane lane_setup(int lane) {
  Lane L;
  L.live = lane < CELLS;
  L.first = lane == 0;
#pragma unroll
  for (int r = 0; r < ROUNDS_FULL; ++r)
    L.rc[r] = L.live ? c_rc_ext[r * CELLS + lane] : 0u;
  L.dm = (L.live && !L.first) ? c_diag_m1[lane] : 0u;
  L.d0 = c_diag_m1[0];
  L.mu0 = add(L.d0, MONT_ONE);
#pragma unroll
  for (int k = 0; k < 5; ++k)
    L.src[k] = L.live ? (lane + 4 * (k + 1)) % CELLS : lane;
  L.m4 = m4_row(lane);
  return L;
}

// M_E = circ(2*M4, M4, ...): the public M4 on each 4-cell block, then each
// cell adds the sum of its position over all blocks.
__device__ __forceinline__ uint32_t warp_external_layer(uint32_t x,
                                                        const Lane& L) {
  uint32_t z = m4_dot(x, __shfl_xor_sync(FULL, x, 1),
                      __shfl_xor_sync(FULL, x, 2),
                      __shfl_xor_sync(FULL, x, 3), L.m4);
  uint32_t g[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) g[k] = __shfl_sync(FULL, z, L.src[k]);
  uint32_t s = add(add(add(z, g[0]), add(g[1], g[2])), add(g[3], g[4]));
  return L.live ? add(z, s) : 0u;
}

__device__ __forceinline__ uint32_t warp_external_round(uint32_t x,
                                                        const Lane& L,
                                                        int r) {
  return warp_external_layer(sbox(add(x, L.rc[r])), L);
}

// The 21 internal rounds, M_I = J + diag(diag_m1). Every lane carries
// y = cell 0 + the round's constant and part = the sum of cells 1..23;
// lane i >= 1 carries cell i in x. With sb the S-box of y, the next y is
// (part + rc) + mu0 sb, one product after the S-box; the next part is
// 23 (part + sb) + sum_{i>=1} d_i x_i, off that chain. Lanes 0 and >= 24
// carry values in x that no one reads (d_i is 0 there).
struct Internal {
  uint32_t y, part, x;
};

// Rounds R..19 (0-based), one template instance a round: unrolled.
template <int R>
__device__ __forceinline__ void warp_internal_from(Internal& s,
                                                   const Lane& L) {
  if constexpr (R < ROUNDS_PARTIAL - 1) {
    uint32_t sb = sbox(s.y);
    uint32_t w = mul(s.x, L.dm);           // d_i x_i; 0 on lanes 0, >= 24
    uint32_t sum = add(s.part, sb);        // sum of all cells after the S-box
    s.y = add(add(s.part, c_rc_int[R + 1]), mul(sb, L.mu0));
    s.part = add(mul(sum, MONT_23), warp_sum(w));
    s.x = add(sum, w);
    warp_internal_from<R + 1>(s, L);
  }
}

// On entry and exit lane i holds cell i (lanes >= 24 hold 0).
__device__ __forceinline__ uint32_t warp_internal_rounds(uint32_t x,
                                                         const Lane& L) {
  Internal s{add(__shfl_sync(FULL, x, 0), c_rc_int[0]),
             warp_sum(L.first || !L.live ? 0u : x), x};
  warp_internal_from<0>(s, L);
  uint32_t sb = sbox(s.y);                 // the last round
  uint32_t sum = add(s.part, sb);
  uint32_t c0 = add(sum, mul(sb, L.d0));
  x = add(sum, mul(s.x, L.dm));
  return L.first ? c0 : (L.live ? x : 0u);
}

__device__ __forceinline__ uint32_t warp_permute(uint32_t x, const Lane& L) {
  x = warp_external_layer(x, L);
#pragma unroll
  for (int r = 0; r < ROUNDS_FULL / 2; ++r) x = warp_external_round(x, L, r);
  x = warp_internal_rounds(x, L);
#pragma unroll
  for (int r = ROUNDS_FULL / 2; r < ROUNDS_FULL; ++r)
    x = warp_external_round(x, L, r);
  return x;
}

// One warp a row: the sponge of each row of an (rows, cols) Montgomery
// matrix, its digest (the first 8 cells) to out[row * 8 ...].
__global__ void __launch_bounds__(WARPS * 32)
warp_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
            int64_t rows, int64_t cols) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * WARPS +
                      (threadIdx.x >> 5);
  if (row >= rows) return;                 // the whole warp: row is its own
  const Lane L = lane_setup(lane);
  const uint32_t* src = in + row * cols;
  const int64_t chunks = cols > 0 ? (cols + RATE - 1) / RATE : 1;
  auto load = [&](int64_t k) -> uint32_t {
    int64_t j = k * RATE + lane;
    return (lane < RATE && j < cols) ? __ldg(src + j) : 0u;
  };
  uint32_t x = 0u;
  uint32_t cur = load(0);
  for (int64_t k = 0; k < chunks; ++k) {
    uint32_t next = k + 1 < chunks ? load(k + 1) : 0u;
    x = warp_permute(add(x, cur), L);      // zero padding adds nothing
    cur = next;
  }
  if (lane < DIGEST) out[row * DIGEST + lane] = x;
}

// Launches warp_kernel on `stream`; returns cudaGetLastError().
int launch_warp_kernel(const void* in, void* out, int64_t rows, int64_t cols,
                       cudaStream_t stream) {
  int64_t blocks = (rows + WARPS - 1) / WARPS;
  warp_kernel<<<static_cast<unsigned>(blocks), WARPS * 32, 0, stream>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), rows,
      cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
