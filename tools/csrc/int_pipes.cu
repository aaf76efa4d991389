// The H100's rates for the integer instructions of the Poseidon2 kernels
// (sm_90a), for tools/torch_leaf_turns.py: each kernel runs one form in
// eight chains a thread (each step reads a neighbouring chain, so ptxas
// cannot fold the steps), with warps enough to fill every scheduler, so
// its time gives the form's throughput. The tool counts the SASS of each
// loop (cuobjdump) and divides.
//
// Forms: 0 mad.lo.u32, 1 mad.hi.u32, 2 mad.wide.u32, 3 add.u32,
// 4 min(x, x - p) (VIADDMNMX), 5 poseidon2.cuh's Montgomery product mul,
// 6 its modular addition add.

#include "poseidon2.cuh"

namespace {

constexpr int CHAINS = 8;
constexpr int PIPE_THREADS = 256;

template <int OP>
__device__ __forceinline__ void step(uint32_t (&a)[CHAINS],
                                     uint64_t (&w)[CHAINS], uint32_t k) {
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    const int n = (j + 1) % CHAINS;
    if constexpr (OP == 0) {
      asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(a[j]) : "r"(a[n]), "r"(k));
    } else if constexpr (OP == 1) {
      asm volatile("mad.hi.u32 %0, %0, %1, %2;" : "+r"(a[j]) : "r"(a[n]), "r"(k));
    } else if constexpr (OP == 2) {
      asm volatile("mad.wide.u32 %0, %1, %2, %0;"
                   : "+l"(w[j]) : "r"(static_cast<uint32_t>(w[j])),
                     "r"(static_cast<uint32_t>(w[n] >> 32)));
    } else if constexpr (OP == 3) {
      asm volatile("add.u32 %0, %0, %1;" : "+r"(a[j]) : "r"(a[n]));
    } else if constexpr (OP == 4) {
      a[j] = min(a[j], a[j] - P);
    } else if constexpr (OP == 5) {
      a[j] = mul(a[j], a[n]);
    } else {
      a[j] = add(a[j], a[n]);
    }
  }
}

template <int OP>
__global__ void __launch_bounds__(PIPE_THREADS)
pipe_kernel(uint32_t* __restrict__ out, int iters, uint32_t k) {
  const uint32_t t = blockIdx.x * PIPE_THREADS + threadIdx.x;
  uint32_t a[CHAINS];
  uint64_t w[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    a[j] = (t * 2654435761u + j * 40503u + k) % P;   // below p, as mul needs
    w[j] = (static_cast<uint64_t>(a[j]) << 32) | (a[j] ^ k);
  }
#pragma unroll 1
  for (int i = 0; i < iters; ++i) step<OP>(a, w, k);
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j)
    x ^= a[j] ^ static_cast<uint32_t>(w[j]) ^ static_cast<uint32_t>(w[j] >> 32);
  out[t] = x;
}

template <int OP>
int launch_pipe(uint32_t* out, int blocks, int iters, uint32_t k,
                cudaStream_t stream) {
  pipe_kernel<OP><<<blocks, PIPE_THREADS, 0, stream>>>(out, iters, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Threads a block of every form's kernel.
int int_pipes_threads() { return PIPE_THREADS; }

// Form `op`'s kernel over `blocks` blocks, `iters` steps of eight chains a
// thread; out holds blocks * int_pipes_threads() words. Returns a
// cudaError_t.
int int_pipes(int op, void* out, int blocks, int iters, uint32_t k,
              void* stream) {
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: return launch_pipe<0>(o, blocks, iters, k, s);
    case 1: return launch_pipe<1>(o, blocks, iters, k, s);
    case 2: return launch_pipe<2>(o, blocks, iters, k, s);
    case 3: return launch_pipe<3>(o, blocks, iters, k, s);
    case 4: return launch_pipe<4>(o, blocks, iters, k, s);
    case 5: return launch_pipe<5>(o, blocks, iters, k, s);
    case 6: return launch_pipe<6>(o, blocks, iters, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
