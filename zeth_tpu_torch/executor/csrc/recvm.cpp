// Recursion-VM witness generator: sequential interpreter for the
// straight-line write-once-memory programs of zeth_tpu_torch/recursion/vm.py
// (a copy of zeth_tpu/executor/csrc/recvm.cpp).
//
// The recursion circuit replaces risc0-circuit-recursion's witgen role
// (SURVEY.md §2.2); programs are hundreds of thousands of rows, so the
// interpreter is native (the numpy reference _witgen_py in vm.py is the
// ground truth this must match bit-for-bit; tests/test_torch_recursion.py
// checks).
//
// Build: make -C . (produces librecvm.so, loaded via ctypes from
// zeth_tpu_torch/recursion/witgen_native.py).

#include <cstdint>
#include <cstring>

typedef uint64_t u64;
typedef unsigned __int128 u128;

static const u64 P = 2013265921ull;     // Baby Bear 15*2^27 + 1
static const int CELLS = 24;
static const int N_SLOTS = 9;

// row types (keep in sync with vm.py)
enum {
  T_FMA = 0, T_IN, T_BIT, T_ASSERT, T_PUB, T_INIT, T_REXT, T_RINT,
  T_ABSLO, T_ABSHI, T_SEL0, T_SEL4, T_DIG, T_DIGHI, T_NOP = 255
};
enum { WF_STREAM = 0, WF_INV = 1, WF_BITOF = 2, WF_EXTINV = 3,
       WF_COMPOF = 4 };

// main column layout (vm.py _ML)
static const int ML_VAL = 0;
static const int ML_ST = ML_VAL + 4 * N_SLOTS;
static const int ML_X3 = ML_ST + CELLS;
static const int ML_N = ML_X3 + CELLS;

static inline u64 addm(u64 a, u64 b) { u64 s = a + b; return s >= P ? s - P : s; }
static inline u64 subm(u64 a, u64 b) { return a >= b ? a - b : a + P - b; }
static inline u64 mulm(u64 a, u64 b) { return (u64)(((u128)a * b) % P); }

static u64 powm(u64 a, u64 e) {
  u64 r = 1;
  while (e) { if (e & 1) r = mulm(r, a); a = mulm(a, a); e >>= 1; }
  return r;
}
static inline u64 invm(u64 a) { return powm(a, P - 2); }

// F_p4 = F_p[x]/(x^4 - BETA), BETA = 11 (zeth_tpu/field.py)
static const u64 BETA = 11;

static void ext_mul(const u64 a[4], const u64 b[4], u64 c[4]) {
  u64 c0 = addm(mulm(a[0], b[0]),
                mulm(BETA, addm(addm(mulm(a[1], b[3]), mulm(a[2], b[2])),
                                mulm(a[3], b[1]))));
  u64 c1 = addm(addm(mulm(a[0], b[1]), mulm(a[1], b[0])),
                mulm(BETA, addm(mulm(a[2], b[3]), mulm(a[3], b[2]))));
  u64 c2 = addm(addm(mulm(a[0], b[2]), mulm(a[1], b[1])),
                addm(mulm(a[2], b[0]), mulm(BETA, mulm(a[3], b[3]))));
  u64 c3 = addm(addm(mulm(a[0], b[3]), mulm(a[1], b[2])),
                addm(mulm(a[2], b[1]), mulm(a[3], b[0])));
  c[0] = c0; c[1] = c1; c[2] = c2; c[3] = c3;
}

static void ext_inv(const u64 a[4], u64 out[4]) {
  // mirrors hostmath.ext_inv
  u64 a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3];
  u64 b0 = addm(mulm(a0, a0),
                mulm(BETA, subm(mulm(a2, a2), mulm(addm(a1, a1), a3))));
  u64 b2 = subm(mulm(addm(a0, a0), a2),
                addm(mulm(a1, a1), mulm(BETA, mulm(a3, a3))));
  u64 dinv = invm(subm(mulm(b0, b0), mulm(BETA, mulm(b2, b2))));
  out[0] = mulm(subm(mulm(a0, b0), mulm(BETA, mulm(a2, b2))), dinv);
  out[1] = mulm(subm(mulm(BETA, mulm(a3, b2)), mulm(a1, b0)), dinv);
  out[2] = mulm(subm(mulm(a2, b0), mulm(a0, b2)), dinv);
  out[3] = mulm(subm(mulm(a1, b2), mulm(a3, b0)), dinv);
}

// Poseidon2 external linear layer M_E = circ(2*M4, M4, ...) over 24 cells
static const u64 M4[4][4] = {
  {5, 7, 1, 3}, {4, 6, 1, 1}, {1, 3, 5, 7}, {1, 1, 4, 6}};

static void ext_layer(u64 st[CELLS]) {
  u64 z[CELLS];
  for (int b = 0; b < CELLS / 4; b++)
    for (int i = 0; i < 4; i++) {
      u64 acc = 0;
      for (int j = 0; j < 4; j++)
        acc = addm(acc, mulm(M4[i][j], st[4 * b + j]));
      z[4 * b + i] = acc;
    }
  u64 s[4] = {0, 0, 0, 0};
  for (int b = 0; b < CELLS / 4; b++)
    for (int i = 0; i < 4; i++) s[i] = addm(s[i], z[4 * b + i]);
  for (int b = 0; b < CELLS / 4; b++)
    for (int i = 0; i < 4; i++) st[4 * b + i] = addm(z[4 * b + i], s[i]);
}

extern "C" int rec_witgen(
    long n_rows, long n_trace, const uint16_t* typ, const int64_t* addr,
    const uint32_t* rc, const uint32_t* /*s3 unused: folded below*/,
    const uint32_t* s3, const int64_t* wf, const u64* stream, long n_stream,
    const u64* mu, long n_cells, u64* out_main, u64* out_wom) {
  u64* wom = out_wom;                      // (n_cells, 4), caller-zeroed
  memset(wom, 0, (size_t)n_cells * 4 * sizeof(u64));
  u64 st[CELLS];
  memset(st, 0, sizeof(st));
  long sp = 0;

  static const int READ_MASK[14] = {
      /*FMA*/ 0x1F, /*IN*/ 0, /*BIT*/ 0, /*ASSERT*/ 1, /*PUB*/ 1,
      /*INIT*/ 0, /*REXT*/ 0, /*RINT*/ 0, /*ABSLO*/ 0xFF, /*ABSHI*/ 0xFF,
      /*SEL0*/ 0x1FF, /*SEL4*/ 0x1FF, /*DIG*/ 0, /*DIGHI*/ 0};

  for (long r = 0; r < n_rows; r++) {
    int t = typ[r];
    u64* mrow = out_main + (size_t)r * ML_N;
    if (t == T_NOP) {
      if (r + 1 < n_trace)
        memcpy(out_main + (size_t)(r + 1) * ML_N + ML_ST, st,
               CELLS * sizeof(u64));
      continue;
    }
    const int64_t* a = addr + (size_t)r * N_SLOTS;
    const uint32_t* rcr = rc + (size_t)r * CELLS;
    u64 vals[N_SLOTS][4];
    memset(vals, 0, sizeof(vals));
    int rm = t < 14 ? READ_MASK[t] : 0;
    for (int slot = 0; slot < N_SLOTS; slot++)
      if (rm & (1 << slot)) {
        const u64* c = wom + (size_t)a[slot] * 4;
        for (int k = 0; k < 4; k++) vals[slot][k] = c[k];
      }

    switch (t) {
      case T_FMA: {
        const uint32_t* sv = s3 + (size_t)r * 3;
        u64 out[4], p01[4], p23[4];
        ext_mul(vals[0], vals[1], p01);
        ext_mul(vals[2], vals[3], p23);
        for (int k = 0; k < 4; k++)
          out[k] = addm(addm(mulm(p01[k], sv[0]), mulm(p23[k], sv[1])),
                        addm(mulm(vals[4][k], sv[2]), rcr[k] % P));
        for (int k = 0; k < 4; k++) vals[5][k] = out[k];
        memcpy(wom + (size_t)a[5] * 4, out, 4 * sizeof(u64));
        break;
      }
      case T_IN:
      case T_BIT: {
        const int64_t* w = wf + (size_t)r * 3;
        u64 v = 0;
        if (w[0] == WF_STREAM) {
          if (sp >= n_stream) return 1;
          v = stream[sp++] % P;
        } else if (w[0] == WF_INV) {
          v = invm(wom[(size_t)w[1] * 4]);
        } else if (w[0] == WF_BITOF) {
          v = (wom[(size_t)w[1] * 4] >> w[2]) & 1;
        } else if (w[0] == WF_EXTINV) {
          u64 iv[4];
          ext_inv(wom + (size_t)w[1] * 4, iv);
          v = iv[w[2]];
        } else if (w[0] == WF_COMPOF) {
          v = wom[(size_t)w[1] * 4 + w[2]];
        } else {
          return 2;
        }
        vals[5][0] = v;
        wom[(size_t)a[5] * 4] = v;
        break;
      }
      case T_ASSERT:
      case T_PUB:
        break;
      case T_INIT: {
        for (int i = 0; i < CELLS; i++) st[i] = addm(st[i], rcr[i] % P);
        ext_layer(st);
        break;
      }
      case T_REXT: {
        u64 tv[CELLS];
        for (int i = 0; i < CELLS; i++) {
          tv[i] = addm(st[i], rcr[i] % P);
          u64 x3 = mulm(mulm(tv[i], tv[i]), tv[i]);
          mrow[ML_X3 + i] = x3;
          st[i] = mulm(mulm(x3, x3), tv[i]);
        }
        ext_layer(st);
        break;
      }
      case T_RINT: {
        for (int rr = 1; rr <= 7; rr++) {
          u64 x = addm(st[0], rcr[rr - 1] % P);
          if (rr >= 2) mrow[ML_X3 + 6 + rr - 1] = x;
          u64 u = mulm(mulm(x, x), x);
          mrow[ML_X3 + rr - 1] = u;
          u64 x7 = mulm(mulm(u, u), x);
          u64 sum = x7;
          for (int i = 1; i < CELLS; i++) sum = addm(sum, st[i]);
          u64 c0 = x7;
          for (int i = CELLS - 1; i >= 1; i--)
            st[i] = addm(sum, mulm(mu[i] >= 1 ? mu[i] - 1 : P - 1, st[i]));
          st[0] = addm(sum, mulm(mu[0] - 1, c0));
        }
        break;
      }
      case T_ABSLO:
      case T_ABSHI: {
        int fresh = (int)wf[(size_t)r * 3 + 2];
        int lo = (t == T_ABSLO) ? 0 : 8;
        for (int i = 0; i < CELLS; i++)
          st[i] = addm(fresh ? 0 : st[i], rcr[i] % P);
        for (int j = 0; j < 8; j++)
          st[lo + j] = addm(st[lo + j], vals[j][0]);
        break;
      }
      case T_SEL0:
      case T_SEL4: {
        int fresh = (int)wf[(size_t)r * 3 + 2];
        int j0 = (t == T_SEL0) ? 0 : 4;
        u64 b = vals[8][0];
        for (int i = 0; i < CELLS; i++)
          st[i] = addm(fresh ? 0 : st[i], rcr[i] % P);
        for (int j = 0; j < 4; j++) {
          u64 x = vals[j][0], y = vals[4 + j][0];
          st[j0 + j] = addm(st[j0 + j], b ? y : x);
          st[8 + j0 + j] = addm(st[8 + j0 + j], b ? x : y);
        }
        break;
      }
      case T_DIG:
      case T_DIGHI: {
        int off = (t == T_DIG) ? 0 : 8;
        for (int s = 0; s < 8; s++) {
          vals[s][0] = st[off + s];
          wom[(size_t)a[s] * 4] = st[off + s];
        }
        break;
      }
      default:
        return 3;
    }
    for (int slot = 0; slot < N_SLOTS; slot++)
      for (int k = 0; k < 4; k++)
        mrow[ML_VAL + 4 * slot + k] = vals[slot][k];
    if (r + 1 < n_trace)
      memcpy(out_main + (size_t)(r + 1) * ML_N + ML_ST, st,
             CELLS * sizeof(u64));
  }
  return sp == n_stream ? 0 : 4;
}
