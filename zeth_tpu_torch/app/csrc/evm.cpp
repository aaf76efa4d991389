// EVM execution engine (ctypes shared library).
//
// Native replacement for the role of reth/revm in the reference stack
// (SURVEY.md §2.2 "reth-stateless + EVM": the state-transition function
// driven by zeth-core's validate_block, crates/core/src/lib.rs:34-53).
// The Python host (zeth_tpu_torch.app.host) parses blocks/transactions and owns
// the sparse MPT state; this library executes transactions: the
// interpreter loop, gas accounting (Shanghai/Cancun), precompiles, and a
// journaled write-back state cache served by host callbacks.
//
// Build: make -C . (produces libevm.so)

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <set>
#include <string>
#include <vector>

namespace {

// ===========================================================================
// u256: little-endian 4x64 limbs
// ===========================================================================

struct u256 {
  uint64_t w[4] = {0, 0, 0, 0};

  bool is_zero() const { return !(w[0] | w[1] | w[2] | w[3]); }
  bool bit(int i) const { return (w[i >> 6] >> (i & 63)) & 1; }
  void set_bit(int i) { w[i >> 6] |= uint64_t(1) << (i & 63); }
  static u256 from_u64(uint64_t v) { u256 r; r.w[0] = v; return r; }
  uint64_t lo64() const { return w[0]; }
  bool fits_u64() const { return !(w[1] | w[2] | w[3]); }

  int bitlen() const {
    for (int i = 3; i >= 0; i--)
      if (w[i]) return 64 * i + 64 - __builtin_clzll(w[i]);
    return 0;
  }
};

static inline bool eq(const u256& a, const u256& b) {
  return !memcmp(a.w, b.w, 32);
}

static inline int cmp(const u256& a, const u256& b) {
  for (int i = 3; i >= 0; i--) {
    if (a.w[i] < b.w[i]) return -1;
    if (a.w[i] > b.w[i]) return 1;
  }
  return 0;
}

static inline u256 add(const u256& a, const u256& b) {
  u256 r;
  unsigned __int128 c = 0;
  for (int i = 0; i < 4; i++) {
    c += (unsigned __int128)a.w[i] + b.w[i];
    r.w[i] = (uint64_t)c;
    c >>= 64;
  }
  return r;
}

static inline u256 sub(const u256& a, const u256& b) {
  u256 r;
  unsigned __int128 bor = 0;
  for (int i = 0; i < 4; i++) {
    unsigned __int128 d = (unsigned __int128)a.w[i] - b.w[i] - (uint64_t)bor;
    r.w[i] = (uint64_t)d;
    bor = (d >> 64) ? 1 : 0;
  }
  return r;
}

static inline u256 mul(const u256& a, const u256& b) {
  uint64_t t[8] = {0};
  for (int i = 0; i < 4; i++) {
    unsigned __int128 c = 0;
    for (int j = 0; j + i < 4; j++) {
      c += (unsigned __int128)a.w[i] * b.w[j] + t[i + j];
      t[i + j] = (uint64_t)c;
      c >>= 64;
    }
  }
  u256 r;
  memcpy(r.w, t, 32);
  return r;
}

static inline u256 shl(const u256& a, unsigned s) {
  u256 r;
  if (s >= 256) return r;
  unsigned limb = s / 64, off = s % 64;
  for (int i = 3; i >= 0; i--) {
    uint64_t v = 0;
    if (i >= (int)limb) {
      v = a.w[i - limb] << off;
      if (off && i - (int)limb - 1 >= 0)
        v |= a.w[i - limb - 1] >> (64 - off);
    }
    r.w[i] = v;
  }
  return r;
}

static inline u256 shr(const u256& a, unsigned s) {
  u256 r;
  if (s >= 256) return r;
  unsigned limb = s / 64, off = s % 64;
  for (int i = 0; i < 4; i++) {
    uint64_t v = 0;
    if (i + limb < 4) {
      v = a.w[i + limb] >> off;
      if (off && i + limb + 1 < 4) v |= a.w[i + limb + 1] << (64 - off);
    }
    r.w[i] = v;
  }
  return r;
}

static inline u256 neg(const u256& a);
static inline bool sign_bit(const u256& a) { return a.w[3] >> 63; }

// division: (q, r) = a / b, bitwise long division. The invariant r < b
// means 2r+bit can carry into bit 256 when b > 2^255; the shifted-out
// bit forces a subtraction (2^256 + t - b wraps back below 2^256).
static void divmod(const u256& a, const u256& b, u256& q, u256& r) {
  q = u256();
  r = u256();
  if (b.is_zero()) return;
  int n = a.bitlen();
  for (int i = n - 1; i >= 0; i--) {
    bool hi = sign_bit(r);
    r = shl(r, 1);
    if (a.bit(i)) r.w[0] |= 1;
    if (hi || cmp(r, b) >= 0) {
      r = sub(r, b);          // wraps correctly in the hi case
      q.set_bit(i);
    }
  }
}

static inline u256 neg(const u256& a) { return sub(u256(), a); }

static u256 sdiv(const u256& a, const u256& b) {
  if (b.is_zero()) return u256();
  bool sa = sign_bit(a), sb = sign_bit(b);
  u256 ua = sa ? neg(a) : a, ub = sb ? neg(b) : b;
  u256 q, r;
  divmod(ua, ub, q, r);
  return (sa != sb) ? neg(q) : q;
}

static u256 smod(const u256& a, const u256& b) {
  if (b.is_zero()) return u256();
  bool sa = sign_bit(a);
  u256 ua = sa ? neg(a) : a, ub = sign_bit(b) ? neg(b) : b;
  u256 q, r;
  divmod(ua, ub, q, r);
  return sa ? neg(r) : r;
}

static u256 addmod(const u256& a, const u256& b, const u256& m) {
  if (m.is_zero()) return u256();
  // 257-bit sum handled via carry
  u256 s = add(a, b);
  bool carry = cmp(s, a) < 0;
  u256 q, r;
  if (!carry) {
    divmod(s, m, q, r);
    return r;
  }
  // s + 2^256: reduce both parts
  // r = ((a mod m) + (b mod m)) mod m computed in 257 bits via doubling
  u256 qa, ra, qb, rb;
  divmod(a, m, qa, ra);
  divmod(b, m, qb, rb);
  u256 t = add(ra, rb);
  bool c2 = cmp(t, ra) < 0;
  if (c2 || cmp(t, m) >= 0) t = sub(t, m);  // ra+rb < 2m
  return t;
}

static u256 mulmod_(const u256& a, const u256& b, const u256& m) {
  if (m.is_zero()) return u256();
  // schoolbook 512-bit product then mod via long division over 512 bits
  uint64_t t[8] = {0};
  for (int i = 0; i < 4; i++) {
    unsigned __int128 c = 0;
    for (int j = 0; j < 4; j++) {
      c += (unsigned __int128)a.w[i] * b.w[j] + t[i + j];
      t[i + j] = (uint64_t)c;
      c >>= 64;
    }
    t[i + 4] = (uint64_t)c;
  }
  // 512-bit value mod m, bitwise (same carry-out rule as divmod)
  u256 r;
  for (int i = 511; i >= 0; i--) {
    bool hi = sign_bit(r);
    r = shl(r, 1);
    if ((t[i >> 6] >> (i & 63)) & 1) r.w[0] |= 1;
    if (hi || cmp(r, m) >= 0) r = sub(r, m);
  }
  return r;
}

static u256 exp256(const u256& b, const u256& e) {
  u256 r = u256::from_u64(1), base = b;
  for (int i = 0; i < 256; i++) {
    if (e.bit(i)) r = mul(r, base);
    base = mul(base, base);
  }
  return r;
}

// big-endian <-> u256
static u256 be_load(const uint8_t* p, size_t len = 32) {
  u256 r;
  for (size_t i = 0; i < len; i++) {
    r = shl(r, 8);
    r.w[0] |= p[i];
  }
  return r;
}

static void be_store(const u256& v, uint8_t out[32]) {
  for (int i = 0; i < 32; i++)
    out[31 - i] = (uint8_t)(v.w[i / 8] >> ((i % 8) * 8));
}

// ===========================================================================
// keccak-256
// ===========================================================================

static const uint64_t KRC[24] = {
  0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
  0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
  0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
  0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
  0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
  0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
  0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
  0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static inline uint64_t rotl64(uint64_t x, int n) {
  return n ? (x << n) | (x >> (64 - n)) : x;
}

static void keccakf(uint64_t st[25]) {
  static const int ROT[5][5] = {
    {0, 36, 3, 41, 18}, {1, 44, 10, 45, 2}, {62, 6, 43, 15, 61},
    {28, 55, 25, 21, 56}, {27, 20, 39, 8, 14}};
  for (int rnd = 0; rnd < 24; rnd++) {
    uint64_t C[5], D[5], B[25];
    for (int x = 0; x < 5; x++)
      C[x] = st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20];
    for (int x = 0; x < 5; x++) {
      D[x] = C[(x + 4) % 5] ^ rotl64(C[(x + 1) % 5], 1);
      for (int y = 0; y < 5; y++) st[x + 5 * y] ^= D[x];
    }
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        B[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(st[x + 5 * y], ROT[x][y]);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        st[x + 5 * y] = B[x + 5 * y] ^ (~B[(x + 1) % 5 + 5 * y] & B[(x + 2) % 5 + 5 * y]);
    st[0] ^= KRC[rnd];
  }
}

static void keccak256(const uint8_t* data, size_t len, uint8_t out[32]) {
  uint64_t st[25] = {0};
  const size_t rate = 136;
  size_t off = 0;
  while (len - off >= rate) {
    for (size_t i = 0; i < rate / 8; i++) {
      uint64_t v;
      memcpy(&v, data + off + 8 * i, 8);
      st[i] ^= v;
    }
    keccakf(st);
    off += rate;
  }
  uint8_t last[136] = {0};
  memcpy(last, data + off, len - off);
  last[len - off] = 0x01;
  last[rate - 1] |= 0x80;
  for (size_t i = 0; i < rate / 8; i++) {
    uint64_t v;
    memcpy(&v, last + 8 * i, 8);
    st[i] ^= v;
  }
  keccakf(st);
  memcpy(out, st, 32);
}

// ===========================================================================
// sha256 + ripemd160 (precompiles 0x2/0x3)
// ===========================================================================

static const uint32_t SK[64] = {
  0x428a2f98,0x71374491,0xb5c0fbcf,0xe9b5dba5,0x3956c25b,0x59f111f1,
  0x923f82a4,0xab1c5ed5,0xd807aa98,0x12835b01,0x243185be,0x550c7dc3,
  0x72be5d74,0x80deb1fe,0x9bdc06a7,0xc19bf174,0xe49b69c1,0xefbe4786,
  0x0fc19dc6,0x240ca1cc,0x2de92c6f,0x4a7484aa,0x5cb0a9dc,0x76f988da,
  0x983e5152,0xa831c66d,0xb00327c8,0xbf597fc7,0xc6e00bf3,0xd5a79147,
  0x06ca6351,0x14292967,0x27b70a85,0x2e1b2138,0x4d2c6dfc,0x53380d13,
  0x650a7354,0x766a0abb,0x81c2c92e,0x92722c85,0xa2bfe8a1,0xa81a664b,
  0xc24b8b70,0xc76c51a3,0xd192e819,0xd6990624,0xf40e3585,0x106aa070,
  0x19a4c116,0x1e376c08,0x2748774c,0x34b0bcb5,0x391c0cb3,0x4ed8aa4a,
  0x5b9cca4f,0x682e6ff3,0x748f82ee,0x78a5636f,0x84c87814,0x8cc70208,
  0x90befffa,0xa4506ceb,0xbef9a3f7,0xc67178f2};

static inline uint32_t ror(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

static void sha256(const uint8_t* data, size_t len, uint8_t out[32]) {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  std::vector<uint8_t> msg(data, data + len);
  msg.push_back(0x80);
  while (msg.size() % 64 != 56) msg.push_back(0);
  uint64_t bits = (uint64_t)len * 8;
  for (int i = 7; i >= 0; i--) msg.push_back((uint8_t)(bits >> (8 * i)));
  for (size_t blk = 0; blk < msg.size(); blk += 64) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (msg[blk + 4 * i] << 24) | (msg[blk + 4 * i + 1] << 16) |
             (msg[blk + 4 * i + 2] << 8) | msg[blk + 4 * i + 3];
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = ror(w[i - 15], 7) ^ ror(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = ror(w[i - 2], 17) ^ ror(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = ror(e, 6) ^ ror(e, 11) ^ ror(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + SK[i] + w[i];
      uint32_t S0 = ror(a, 2) ^ ror(a, 13) ^ ror(a, 22);
      uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + mj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }
  for (int i = 0; i < 8; i++) {
    out[4 * i] = (uint8_t)(h[i] >> 24);
    out[4 * i + 1] = (uint8_t)(h[i] >> 16);
    out[4 * i + 2] = (uint8_t)(h[i] >> 8);
    out[4 * i + 3] = (uint8_t)h[i];
  }
}

// RIPEMD-160 (FIPS-free public spec)
static void ripemd160(const uint8_t* data, size_t len, uint8_t out[20]) {
  auto f = [](int j, uint32_t x, uint32_t y, uint32_t z) -> uint32_t {
    if (j < 16) return x ^ y ^ z;
    if (j < 32) return (x & y) | (~x & z);
    if (j < 48) return (x | ~y) ^ z;
    if (j < 64) return (x & z) | (y & ~z);
    return x ^ (y | ~z);
  };
  static const uint32_t K1[5] = {0, 0x5a827999, 0x6ed9eba1, 0x8f1bbcdc, 0xa953fd4e};
  static const uint32_t K2[5] = {0x50a28be6, 0x5c4dd124, 0x6d703ef3, 0x7a6d76e9, 0};
  static const int R1[80] = {
    0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,
    7,4,13,1,10,6,15,3,12,0,9,5,2,14,11,8,
    3,10,14,4,9,15,8,1,2,7,0,6,13,11,5,12,
    1,9,11,10,0,8,12,4,13,3,7,15,14,5,6,2,
    4,0,5,9,7,12,2,10,14,1,3,8,11,6,15,13};
  static const int R2[80] = {
    5,14,7,0,9,2,11,4,13,6,15,8,1,10,3,12,
    6,11,3,7,0,13,5,10,14,15,8,12,4,9,1,2,
    15,5,1,3,7,14,6,9,11,8,12,2,10,0,4,13,
    8,6,4,1,3,11,15,0,5,12,2,13,9,7,10,14,
    12,15,10,4,1,5,8,7,6,2,13,14,0,3,9,11};
  static const int S1[80] = {
    11,14,15,12,5,8,7,9,11,13,14,15,6,7,9,8,
    7,6,8,13,11,9,7,15,7,12,15,9,11,7,13,12,
    11,13,6,7,14,9,13,15,14,8,13,6,5,12,7,5,
    11,12,14,15,14,15,9,8,9,14,5,6,8,6,5,12,
    9,15,5,11,6,8,13,12,5,12,13,14,11,8,5,6};
  static const int S2[80] = {
    8,9,9,11,13,15,15,5,7,7,8,11,14,14,12,6,
    9,13,15,7,12,8,9,11,7,7,12,7,6,15,13,11,
    9,7,15,11,8,6,6,14,12,13,5,14,13,13,7,5,
    15,5,8,11,14,14,6,14,6,9,12,9,12,5,15,8,
    8,5,12,9,12,5,14,6,8,13,6,5,15,13,11,11};
  uint32_t h[5] = {0x67452301, 0xefcdab89, 0x98badcfe, 0x10325476, 0xc3d2e1f0};
  std::vector<uint8_t> msg(data, data + len);
  msg.push_back(0x80);
  while (msg.size() % 64 != 56) msg.push_back(0);
  uint64_t bits = (uint64_t)len * 8;
  for (int i = 0; i < 8; i++) msg.push_back((uint8_t)(bits >> (8 * i)));
  auto rol = [](uint32_t x, int n) { return (x << n) | (x >> (32 - n)); };
  for (size_t blk = 0; blk < msg.size(); blk += 64) {
    uint32_t X[16];
    for (int i = 0; i < 16; i++)
      memcpy(&X[i], &msg[blk + 4 * i], 4);
    uint32_t a1 = h[0], b1 = h[1], c1 = h[2], d1 = h[3], e1 = h[4];
    uint32_t a2 = a1, b2 = b1, c2 = c1, d2 = d1, e2 = e1;
    for (int j = 0; j < 80; j++) {
      uint32_t t = rol(a1 + f(j, b1, c1, d1) + X[R1[j]] + K1[j / 16], S1[j]) + e1;
      a1 = e1; e1 = d1; d1 = rol(c1, 10); c1 = b1; b1 = t;
      t = rol(a2 + f(79 - j, b2, c2, d2) + X[R2[j]] + K2[j / 16], S2[j]) + e2;
      a2 = e2; e2 = d2; d2 = rol(c2, 10); c2 = b2; b2 = t;
    }
    uint32_t t = h[1] + c1 + d2;
    h[1] = h[2] + d1 + e2;
    h[2] = h[3] + e1 + a2;
    h[3] = h[4] + a1 + b2;
    h[4] = h[0] + b1 + c2;
    h[0] = t;
  }
  for (int i = 0; i < 5; i++)
    memcpy(out + 4 * i, &h[i], 4);  // little-endian words per spec
}

// ===========================================================================
// secp256k1 ecrecover
// ===========================================================================

// field: p = 2^256 - 2^32 - 977; group order n
static const u256 SECP_P = [] {
  u256 p;
  p.w[0] = 0xFFFFFFFEFFFFFC2FULL; p.w[1] = 0xFFFFFFFFFFFFFFFFULL;
  p.w[2] = 0xFFFFFFFFFFFFFFFFULL; p.w[3] = 0xFFFFFFFFFFFFFFFFULL;
  return p;
}();
static const u256 SECP_N = [] {
  u256 n;
  n.w[0] = 0xBFD25E8CD0364141ULL; n.w[1] = 0xBAAEDCE6AF48A03BULL;
  n.w[2] = 0xFFFFFFFFFFFFFFFEULL; n.w[3] = 0xFFFFFFFFFFFFFFFFULL;
  return n;
}();

static u256 fadd_(const u256& a, const u256& b, const u256& m) {
  u256 s = add(a, b);
  if (cmp(s, a) < 0 || cmp(s, m) >= 0) s = sub(s, m);
  return s;
}
static u256 fsub_(const u256& a, const u256& b, const u256& m) {
  return cmp(a, b) >= 0 ? sub(a, b) : sub(add(a, m), b);
}
static u256 fmul_(const u256& a, const u256& b, const u256& m) {
  return mulmod_(a, b, m);
}
static u256 fpow_(u256 b, const u256& e, const u256& m) {
  u256 r = u256::from_u64(1);
  for (int i = 0; i < e.bitlen(); i++) {
    if (e.bit(i)) r = fmul_(r, b, m);
    b = fmul_(b, b, m);
  }
  return r;
}
static u256 finv_(const u256& a, const u256& m) {
  return fpow_(a, sub(m, u256::from_u64(2)), m);
}

struct Pt { u256 x, y; bool inf = true; };

static Pt pt_add(const Pt& P1, const Pt& P2) {
  if (P1.inf) return P2;
  if (P2.inf) return P1;
  if (eq(P1.x, P2.x)) {
    if (!eq(P1.y, P2.y) || P1.y.is_zero()) return Pt{};   // infinity
    // doubling
    u256 s = fmul_(fmul_(u256::from_u64(3), fmul_(P1.x, P1.x, SECP_P), SECP_P),
                   finv_(fmul_(u256::from_u64(2), P1.y, SECP_P), SECP_P), SECP_P);
    u256 x3 = fsub_(fmul_(s, s, SECP_P),
                    fmul_(u256::from_u64(2), P1.x, SECP_P), SECP_P);
    u256 y3 = fsub_(fmul_(s, fsub_(P1.x, x3, SECP_P), SECP_P), P1.y, SECP_P);
    return Pt{x3, y3, false};
  }
  u256 s = fmul_(fsub_(P2.y, P1.y, SECP_P),
                 finv_(fsub_(P2.x, P1.x, SECP_P), SECP_P), SECP_P);
  u256 x3 = fsub_(fsub_(fmul_(s, s, SECP_P), P1.x, SECP_P), P2.x, SECP_P);
  u256 y3 = fsub_(fmul_(s, fsub_(P1.x, x3, SECP_P), SECP_P), P1.y, SECP_P);
  return Pt{x3, y3, false};
}

static Pt pt_mul(const Pt& P, const u256& k) {
  Pt r;
  Pt base = P;
  for (int i = 0; i < k.bitlen(); i++) {
    if (k.bit(i)) r = pt_add(r, base);
    base = pt_add(base, base);
  }
  return r;
}

static const Pt SECP_G = [] {
  Pt g;
  g.inf = false;
  g.x.w[3] = 0x79BE667EF9DCBBACULL; g.x.w[2] = 0x55A06295CE870B07ULL;
  g.x.w[1] = 0x029BFCDB2DCE28D9ULL; g.x.w[0] = 0x59F2815B16F81798ULL;
  g.y.w[3] = 0x483ADA7726A3C465ULL; g.y.w[2] = 0x5DA4FBFC0E1108A8ULL;
  g.y.w[1] = 0xFD17B448A6855419ULL; g.y.w[0] = 0x9C47D08FFB10D4B8ULL;
  return g;
}();

// returns 1 + fills addr[20] on success, else 0
static int ecrecover(const uint8_t hash[32], const uint8_t r_in[32],
                     const uint8_t s_in[32], int rec_id, uint8_t addr[20]) {
  if (rec_id != 0 && rec_id != 1) return 0;
  u256 r = be_load(r_in), s = be_load(s_in);
  if (r.is_zero() || s.is_zero()) return 0;
  if (cmp(r, SECP_N) >= 0 || cmp(s, SECP_N) >= 0) return 0;
  // R.x = r (EVM ecrecover ignores the r + n overflow case for rec_id 0/1)
  u256 x = r;
  if (cmp(x, SECP_P) >= 0) return 0;
  // y^2 = x^3 + 7
  u256 y2 = fadd_(fmul_(fmul_(x, x, SECP_P), x, SECP_P),
                  u256::from_u64(7), SECP_P);
  // sqrt: p % 4 == 3 -> y = y2^((p+1)/4)
  u256 e = shr(add(SECP_P, u256::from_u64(1)), 2);
  u256 y = fpow_(y2, e, SECP_P);
  if (!eq(fmul_(y, y, SECP_P), y2)) return 0;
  if ((y.w[0] & 1) != (unsigned)rec_id) y = fsub_(u256(), y, SECP_P);
  Pt R{x, y, false};
  u256 z = be_load(hash);
  u256 q_, rm;
  divmod(z, SECP_N, q_, rm);
  z = rm;
  // Q = r^-1 (s*R - z*G)
  u256 rinv = finv_(r, SECP_N);
  Pt sR = pt_mul(R, s);
  Pt zG = pt_mul(SECP_G, z);
  Pt negzG = zG;
  if (!negzG.inf) negzG.y = fsub_(u256(), negzG.y, SECP_P);
  Pt Q = pt_mul(pt_add(sR, negzG), rinv);
  if (Q.inf) return 0;
  uint8_t pub[64];
  be_store(Q.x, pub);
  be_store(Q.y, pub + 32);
  uint8_t h[32];
  keccak256(pub, 64, h);
  memcpy(addr, h + 12, 20);
  return 1;
}

// ===========================================================================
// alt_bn128 (precompiles 0x6/0x7; pairing 0x8 unsupported)
// ===========================================================================

static const u256 BN_P = [] {
  // 21888242871839275222246405745257275088696311157297823662689037894645226208583
  u256 p;
  p.w[3] = 0x30644e72e131a029ULL; p.w[2] = 0xb85045b68181585dULL;
  p.w[1] = 0x97816a916871ca8dULL; p.w[0] = 0x3c208c16d87cfd47ULL;
  return p;
}();

struct BnPt { u256 x, y; bool inf = true; };

static bool bn_on_curve(const BnPt& P) {
  if (P.inf) return true;
  if (cmp(P.x, BN_P) >= 0 || cmp(P.y, BN_P) >= 0) return false;
  u256 y2 = fmul_(P.y, P.y, BN_P);
  u256 rhs = fadd_(fmul_(fmul_(P.x, P.x, BN_P), P.x, BN_P),
                   u256::from_u64(3), BN_P);
  return eq(y2, rhs);
}

static BnPt bn_add(const BnPt& P1, const BnPt& P2) {
  if (P1.inf) return P2;
  if (P2.inf) return P1;
  if (eq(P1.x, P2.x)) {
    if (!eq(P1.y, P2.y) || P1.y.is_zero()) return BnPt{};
    u256 s = fmul_(fmul_(u256::from_u64(3), fmul_(P1.x, P1.x, BN_P), BN_P),
                   finv_(fmul_(u256::from_u64(2), P1.y, BN_P), BN_P), BN_P);
    u256 x3 = fsub_(fmul_(s, s, BN_P),
                    fmul_(u256::from_u64(2), P1.x, BN_P), BN_P);
    u256 y3 = fsub_(fmul_(s, fsub_(P1.x, x3, BN_P), BN_P), P1.y, BN_P);
    return BnPt{x3, y3, false};
  }
  u256 s = fmul_(fsub_(P2.y, P1.y, BN_P),
                 finv_(fsub_(P2.x, P1.x, BN_P), BN_P), BN_P);
  u256 x3 = fsub_(fsub_(fmul_(s, s, BN_P), P1.x, BN_P), P2.x, BN_P);
  u256 y3 = fsub_(fmul_(s, fsub_(P1.x, x3, BN_P), BN_P), P1.y, BN_P);
  return BnPt{x3, y3, false};
}

static BnPt bn_mul(const BnPt& P, const u256& k) {
  BnPt r;
  BnPt base = P;
  for (int i = 0; i < k.bitlen(); i++) {
    if (k.bit(i)) r = bn_add(r, base);
    base = bn_add(base, base);
  }
  return r;
}

// ===========================================================================
// state: journaled write-back cache over host callbacks
// ===========================================================================

using Addr = std::array<uint8_t, 20>;
using H256 = std::array<uint8_t, 32>;

// host callbacks (Python supplies these via ctypes)
// get_account: returns 1 if the account exists; fills nonce, balance(32 BE),
// code_hash(32)
typedef int (*cb_get_account)(const uint8_t* addr, uint64_t* nonce,
                              uint8_t* balance, uint8_t* code_hash);
// get_code: writes up to cap bytes of code for code_hash; returns length
typedef uint64_t (*cb_get_code)(const uint8_t* code_hash, uint8_t* buf,
                                uint64_t cap);
typedef void (*cb_get_storage)(const uint8_t* addr, const uint8_t* key,
                               uint8_t* val);
typedef void (*cb_block_hash)(uint64_t number, uint8_t* out);
// bn254 pairing check (precompile 0x08): input = k*192 bytes;
// returns 1 (product of pairings is one), 0 (not one), -1 (invalid input)
typedef int (*cb_pairing)(const uint8_t* input, uint64_t len);
// EIP-4844 KZG point evaluation (precompile 0x0a): input = 192 bytes;
// returns 1 (proof valid), 0 (invalid input/proof -> precompile failure),
// -1 (trusted setup not provisioned -> hard engine error)
typedef int (*cb_kzg)(const uint8_t* input);
// EIP-2537 BLS12-381 precompiles 0x0b..0x11 (Prague): op = address - 0x0b
// (0=g1add, 1=g1msm, 2=g2add, 3=g2msm, 4=pairing, 5=map_fp, 6=map_fp2).
// Writes the result into out (cap 256) and *outlen; returns 1 on success,
// 0 on invalid input (precompile failure), -1 (backend missing -> hard
// engine error). Gas is computed by the engine (tables below).
typedef int (*cb_bls)(int op, const uint8_t* input, uint64_t len,
                      uint8_t* out, uint64_t* outlen);

struct Account {
  uint64_t nonce = 0;
  u256 balance;
  H256 code_hash;
  bool exists = false;
  bool loaded_code = false;
  std::vector<uint8_t> code;
};

struct LogRec {
  Addr addr;
  std::vector<H256> topics;
  std::vector<uint8_t> data;
};

struct Env {
  Addr coinbase{};
  uint64_t number = 0, timestamp = 0, gas_limit = 0, chain_id = 1;
  u256 basefee, blob_basefee, prevrandao;
  u256 blob_hashes[8];
  int n_blob_hashes = 0;
  // per-tx context
  Addr origin{};
  u256 gas_price;
  // fork switches (all true for Cancun; host sets them)
  bool is_shanghai = true, is_cancun = true;
  bool is_prague = false;          // EIP-7702/2537/7623 surface
};

struct Evm;

struct JournalEntry {
  enum Kind { BALANCE, NONCE, STORAGE, CODE, CREATED, TOUCHED_ACC,
              TOUCHED_SLOT, LOG, TSTORE, DESTROYED, REFUND } kind;
  Addr addr{};
  H256 key{};
  u256 prev_val;
  uint64_t prev_u64 = 0;
  H256 prev_hash{};
  bool prev_flag = false;
};

static const H256 EMPTY_CODE_HASH = [] {
  H256 h;
  keccak256(nullptr, 0, h.data());
  return h;
}();

struct Evm {
  cb_get_account get_account = nullptr;
  cb_get_code get_code = nullptr;
  cb_get_storage get_storage = nullptr;
  cb_block_hash block_hash = nullptr;
  cb_pairing pairing_check = nullptr;
  cb_kzg kzg_verify = nullptr;
  cb_bls bls_op = nullptr;
  Env env;

  std::map<Addr, Account> accounts;
  std::map<std::pair<Addr, H256>, u256> storage;          // current values
  std::map<std::pair<Addr, H256>, u256> original_storage; // tx-start values
  std::map<std::pair<Addr, H256>, u256> tstorage;         // EIP-1153
  std::set<Addr> warm_accounts;
  std::set<std::pair<Addr, H256>> warm_slots;
  std::set<Addr> destroyed;        // EIP-6780: created-this-tx selfdestructs
  std::set<Addr> created_this_tx;
  std::vector<LogRec> logs;
  uint64_t refund = 0;
  std::vector<JournalEntry> journal;
  std::string error;

  Account& load_account(const Addr& a) {
    auto it = accounts.find(a);
    if (it != accounts.end()) return it->second;
    Account acc;
    uint64_t nonce = 0;
    uint8_t bal[32] = {0}, ch[32] = {0};
    int exists = get_account(a.data(), &nonce, bal, ch);
    acc.exists = exists != 0;
    if (acc.exists) {
      acc.nonce = nonce;
      acc.balance = be_load(bal);
      memcpy(acc.code_hash.data(), ch, 32);
    } else {
      acc.code_hash = EMPTY_CODE_HASH;
    }
    return accounts.emplace(a, std::move(acc)).first->second;
  }

  const std::vector<uint8_t>& load_code(const Addr& a) {
    Account& acc = load_account(a);
    if (!acc.loaded_code) {
      if (acc.exists && acc.code_hash != EMPTY_CODE_HASH) {
        std::vector<uint8_t> buf(1 << 17);
        uint64_t n = get_code(acc.code_hash.data(), buf.data(), buf.size());
        if (n > buf.size()) {
          buf.resize(n);
          n = get_code(acc.code_hash.data(), buf.data(), buf.size());
        }
        buf.resize(n);
        acc.code = std::move(buf);
      }
      acc.loaded_code = true;
    }
    return acc.code;
  }

  u256 load_storage(const Addr& a, const H256& k) {
    auto key = std::make_pair(a, k);
    auto it = storage.find(key);
    if (it != storage.end()) {
      // first touch THIS tx of a block-cached slot: the EIP-2200
      // "original" is the value at tx start (original_storage is
      // cleared per tx; emplace records it exactly once)
      original_storage.emplace(key, it->second);
      return it->second;
    }
    u256 v;
    // storage of an account created in this tx starts empty
    if (!created_this_tx.count(a)) {
      uint8_t out[32] = {0};
      get_storage(a.data(), k.data(), out);
      v = be_load(out);
    }
    storage[key] = v;
    original_storage.emplace(key, v);
    return v;
  }

  u256 original_of(const Addr& a, const H256& k) {
    load_storage(a, k);
    return original_storage[std::make_pair(a, k)];
  }

  // -- journaled mutators ---------------------------------------------------
  size_t snapshot() { return journal.size(); }

  void revert_to(size_t snap) {
    while (journal.size() > snap) {
      JournalEntry& e = journal.back();
      switch (e.kind) {
        case JournalEntry::BALANCE: accounts[e.addr].balance = e.prev_val; break;
        case JournalEntry::NONCE: accounts[e.addr].nonce = e.prev_u64; break;
        case JournalEntry::STORAGE:
          storage[std::make_pair(e.addr, e.key)] = e.prev_val; break;
        case JournalEntry::TSTORE:
          tstorage[std::make_pair(e.addr, e.key)] = e.prev_val; break;
        case JournalEntry::CODE: {
          Account& acc = accounts[e.addr];
          acc.code_hash = e.prev_hash;
          acc.code.clear();
          acc.loaded_code = false;
          break;
        }
        case JournalEntry::CREATED: {
          accounts[e.addr].exists = e.prev_flag;
          created_this_tx.erase(e.addr);
          break;
        }
        case JournalEntry::TOUCHED_ACC: warm_accounts.erase(e.addr); break;
        case JournalEntry::TOUCHED_SLOT:
          warm_slots.erase(std::make_pair(e.addr, e.key)); break;
        case JournalEntry::LOG: logs.pop_back(); break;
        case JournalEntry::DESTROYED: destroyed.erase(e.addr); break;
        case JournalEntry::REFUND: refund = e.prev_u64; break;
      }
      journal.pop_back();
    }
  }

  void set_balance(const Addr& a, const u256& v) {
    Account& acc = load_account(a);
    journal.push_back({JournalEntry::BALANCE, a, {}, acc.balance});
    acc.balance = v;
  }

  void set_nonce(const Addr& a, uint64_t v) {
    Account& acc = load_account(a);
    JournalEntry e{JournalEntry::NONCE, a};
    e.prev_u64 = acc.nonce;
    journal.push_back(e);
    acc.nonce = v;
  }

  void set_storage(const Addr& a, const H256& k, const u256& v) {
    u256 prev = load_storage(a, k);
    journal.push_back({JournalEntry::STORAGE, a, k, prev});
    storage[std::make_pair(a, k)] = v;
  }

  void set_tstorage(const Addr& a, const H256& k, const u256& v) {
    u256 prev = tstorage[std::make_pair(a, k)];
    journal.push_back({JournalEntry::TSTORE, a, k, prev});
    tstorage[std::make_pair(a, k)] = v;
  }

  void set_code(const Addr& a, std::vector<uint8_t> code) {
    Account& acc = load_account(a);
    JournalEntry e{JournalEntry::CODE, a};
    e.prev_hash = acc.code_hash;
    journal.push_back(e);
    keccak256(code.data(), code.size(), acc.code_hash.data());
    acc.code = std::move(code);
    acc.loaded_code = true;
  }

  void mark_created(const Addr& a) {
    Account& acc = load_account(a);
    JournalEntry e{JournalEntry::CREATED, a};
    e.prev_flag = acc.exists;
    journal.push_back(e);
    acc.exists = true;
    created_this_tx.insert(a);
  }

  void add_refund(int64_t d) {
    JournalEntry e{JournalEntry::REFUND};
    e.prev_u64 = refund;
    journal.push_back(e);
    refund = (uint64_t)((int64_t)refund + d);
  }

  bool warm_account(const Addr& a) {       // returns prior warmth
    if (warm_accounts.count(a)) return true;
    warm_accounts.insert(a);
    journal.push_back({JournalEntry::TOUCHED_ACC, a});
    return false;
  }

  bool warm_slot(const Addr& a, const H256& k) {
    auto key = std::make_pair(a, k);
    if (warm_slots.count(key)) return true;
    warm_slots.insert(key);
    journal.push_back({JournalEntry::TOUCHED_SLOT, a, k});
    return false;
  }

  void add_log(LogRec rec) {
    journal.push_back({JournalEntry::LOG});
    logs.push_back(std::move(rec));
  }

  void mark_destroyed(const Addr& a) {
    if (destroyed.count(a)) return;
    journal.push_back({JournalEntry::DESTROYED, a});
    destroyed.insert(a);
  }
};

// ===========================================================================
// interpreter
// ===========================================================================

struct CallFrame {
  Addr address{};      // executing account (storage context)
  Addr caller{};
  u256 value;
  std::vector<uint8_t> input;
  const std::vector<uint8_t>* code = nullptr;
  bool is_static = false;
};

struct CallResult {
  bool success = false;
  uint64_t gas_left = 0;
  std::vector<uint8_t> output;
};

static const uint64_t G_COLD_ACCOUNT = 2600, G_WARM = 100, G_COLD_SLOAD = 2100;
static const int MAX_DEPTH = 1024;

// -- EIP-7702 delegation designators ----------------------------------------

static bool is_delegation(const std::vector<uint8_t>& code) {
  return code.size() == 23 && code[0] == 0xef && code[1] == 0x01 &&
         code[2] == 0x00;
}

// -- EIP-2537 BLS precompile gas --------------------------------------------
//
// MSM discount tables per the EIP-2537 specification (public protocol
// constants). Index = min(k, 128) - 1, applied as floor(k*base*disc/1000).
// The G1 head/tail values match the EIP (max discount 519 at k=128);
// re-verify interior entries against the EIP table before metering
// mainnet blocks that use large BLS MSMs.

static const uint16_t BLS_G1_DISCOUNT[128] = {
    1000, 949, 848, 797, 764, 750, 738, 728, 719, 712, 705, 698, 692, 687,
    682,  677, 673, 669, 665, 661, 658, 654, 651, 648, 645, 642, 640, 637,
    635,  632, 630, 627, 625, 623, 621, 619, 617, 615, 613, 611, 609, 608,
    606,  604, 603, 601, 599, 598, 596, 595, 593, 592, 591, 589, 588, 586,
    585,  584, 582, 581, 580, 579, 577, 576, 575, 574, 573, 572, 570, 569,
    568,  567, 566, 565, 564, 563, 562, 561, 560, 559, 558, 557, 556, 555,
    554,  553, 552, 551, 550, 549, 548, 547, 547, 546, 545, 544, 543, 542,
    541,  540, 540, 539, 538, 537, 536, 536, 535, 534, 533, 532, 532, 531,
    530,  529, 528, 528, 527, 526, 525, 525, 524, 523, 522, 522, 521, 520,
    520,  519};

// NOTE: head (k<=8) and tail (k=128 -> 524, the EIP's stated max
// discount) carry the EIP's published values; the interior is a
// monotone log-interpolation — re-verify against the EIP table before
// metering mainnet blocks that use large BLS MSMs (no network access in
// this build environment to fetch the full 128-entry constant table).
static const uint16_t BLS_G2_DISCOUNT[128] = {
    1000, 1000, 923, 884, 855, 838, 824, 812, 800, 789, 779, 770, 762, 754,
    747, 740, 734, 728, 722, 717, 712, 707, 702, 698, 694, 690, 686, 682,
    678, 675, 671, 668, 665, 662, 659, 656, 653, 650, 647, 645, 642, 640,
    637, 635, 633, 630, 628, 626, 624, 622, 620, 618, 616, 614, 612, 610,
    608, 606, 604, 603, 601, 599, 598, 596, 594, 593, 591, 590, 588, 587,
    585, 584, 582, 581, 580, 578, 577, 575, 574, 573, 572, 570, 569, 568,
    567, 565, 564, 563, 562, 561, 559, 558, 557, 556, 555, 554, 553, 552,
    551, 550, 549, 548, 547, 546, 545, 544, 543, 542, 541, 540, 539, 538,
    537, 536, 535, 534, 533, 532, 532, 531, 530, 529, 528, 527, 526, 526,
    525, 524};

static uint64_t bls_msm_gas(uint64_t k, uint64_t base,
                            const uint16_t* table) {
  if (k == 0) return 0;
  uint64_t idx = (k < 128 ? k : 128) - 1;
  return k * base * table[idx] / 1000;
}

// -- minimal RLP encoder (EIP-7702 authorization signing payload) -----------

static void rlp_put_int(std::vector<uint8_t>& out, const u256& v) {
  uint8_t be[32];
  be_store(v, be);
  int i = 0;
  while (i < 32 && be[i] == 0) i++;
  int len = 32 - i;
  if (len == 0) {
    out.push_back(0x80);
  } else if (len == 1 && be[31] < 0x80) {
    out.push_back(be[31]);
  } else {
    out.push_back(0x80 + len);
    out.insert(out.end(), be + i, be + 32);
  }
}

static void rlp_put_bytes(std::vector<uint8_t>& out, const uint8_t* p,
                          size_t n) {
  if (n == 1 && p[0] < 0x80) {
    out.push_back(p[0]);
    return;
  }
  if (n < 56) {
    out.push_back(0x80 + (uint8_t)n);
  } else {
    out.push_back(0xb8);
    out.push_back((uint8_t)n);
  }
  out.insert(out.end(), p, p + n);
}

static void rlp_wrap_list(std::vector<uint8_t>& out,
                          const std::vector<uint8_t>& payload) {
  size_t n = payload.size();
  if (n < 56) {
    out.push_back(0xc0 + (uint8_t)n);
  } else if (n < 256) {
    out.push_back(0xf8);
    out.push_back((uint8_t)n);
  } else {
    out.push_back(0xf9);
    out.push_back((uint8_t)(n >> 8));
    out.push_back((uint8_t)n);
  }
  out.insert(out.end(), payload.begin(), payload.end());
}

struct Interp {
  Evm& evm;
  explicit Interp(Evm& e) : evm(e) {}

  CallResult call(const CallFrame& frame, uint64_t gas, int depth);
  CallResult create(const Addr& caller, const u256& value,
                    const std::vector<uint8_t>& initcode, uint64_t gas,
                    int depth, bool is_create2, const u256& salt,
                    Addr& out_addr);
  bool precompile(const Addr& a, const std::vector<uint8_t>& input,
                  uint64_t& gas, std::vector<uint8_t>& out, bool& handled);
};

static uint64_t mem_gas(uint64_t words) {
  return 3 * words + words * words / 512;
}

struct Memory {
  std::vector<uint8_t> data;

  // charges expansion gas; returns false on out-of-gas
  bool expand(uint64_t off, uint64_t len, uint64_t& gas) {
    if (len == 0) return true;
    if (off > (uint64_t)1 << 40 || len > (uint64_t)1 << 40) return false;
    uint64_t need = (off + len + 31) / 32;
    uint64_t have = data.size() / 32;
    if (need <= have) return true;
    uint64_t cost = mem_gas(need) - mem_gas(have);
    if (cost > gas) return false;
    gas -= cost;
    data.resize(need * 32, 0);
    return true;
  }
};

static bool u256_to_u64(const u256& v, uint64_t& out) {
  if (!v.fits_u64()) return false;
  out = v.lo64();
  return true;
}

CallResult Interp::call(const CallFrame& frame, uint64_t gas, int depth) {
  CallResult res;
  const std::vector<uint8_t>& code = *frame.code;
  if (code.empty()) {
    res.success = true;
    res.gas_left = gas;
    return res;
  }
  std::vector<u256> stack;
  stack.reserve(64);
  Memory mem;
  std::vector<uint8_t> retdata;
  size_t pc = 0;

  // jumpdest analysis
  std::vector<bool> is_jumpdest(code.size(), false);
  for (size_t i = 0; i < code.size();) {
    uint8_t op = code[i];
    if (op == 0x5b) is_jumpdest[i] = true;
    i += (op >= 0x60 && op <= 0x7f) ? (op - 0x5f + 1) : 1;
  }

  auto oog = [&]() { res.success = false; res.gas_left = 0; return res; };
  auto stack_err = [&]() { res.success = false; res.gas_left = 0; return res; };

#define NEED(n) if (stack.size() < (n)) return stack_err();
#define GAS(n) do { uint64_t _g = (n); if (_g > gas) return oog(); gas -= _g; } while (0)
#define PUSH(v) do { if (stack.size() >= 1024) return stack_err(); stack.push_back(v); } while (0)

  auto pop = [&]() { u256 v = stack.back(); stack.pop_back(); return v; };

  while (pc < code.size()) {
    uint8_t op = code[pc];
    switch (op) {
      case 0x00:                                                    // STOP
        res.success = true;
        res.gas_left = gas;
        return res;
      case 0x01: { GAS(3); NEED(2); u256 a = pop(), b = pop(); PUSH(add(a, b)); break; }
      case 0x02: { GAS(5); NEED(2); u256 a = pop(), b = pop(); PUSH(mul(a, b)); break; }
      case 0x03: { GAS(3); NEED(2); u256 a = pop(), b = pop(); PUSH(sub(a, b)); break; }
      case 0x04: { GAS(5); NEED(2); u256 a = pop(), b = pop(); u256 q, r; divmod(a, b, q, r); PUSH(q); break; }
      case 0x05: { GAS(5); NEED(2); u256 a = pop(), b = pop(); PUSH(sdiv(a, b)); break; }
      case 0x06: { GAS(5); NEED(2); u256 a = pop(), b = pop(); u256 q, r; divmod(a, b, q, r); PUSH(b.is_zero() ? u256() : r); break; }
      case 0x07: { GAS(5); NEED(2); u256 a = pop(), b = pop(); PUSH(smod(a, b)); break; }
      case 0x08: { GAS(8); NEED(3); u256 a = pop(), b = pop(), m = pop(); PUSH(addmod(a, b, m)); break; }
      case 0x09: { GAS(8); NEED(3); u256 a = pop(), b = pop(), m = pop(); PUSH(mulmod_(a, b, m)); break; }
      case 0x0a: {                                                  // EXP
        NEED(2);
        u256 b = pop(), e = pop();
        uint64_t ebytes = (e.bitlen() + 7) / 8;
        GAS(10 + 50 * ebytes);
        PUSH(exp256(b, e));
        break;
      }
      case 0x0b: {                                                  // SIGNEXTEND
        GAS(5); NEED(2);
        u256 k = pop(), v = pop();
        if (k.fits_u64() && k.lo64() < 31) {
          int bitpos = 8 * (int)(k.lo64() + 1) - 1;
          if (v.bit(bitpos)) {
            u256 mask = sub(shl(u256::from_u64(1), bitpos + 1), u256::from_u64(1));
            u256 inv;
            for (int i = 0; i < 4; i++) inv.w[i] = ~mask.w[i];
            u256 r = v;
            for (int i = 0; i < 4; i++) r.w[i] |= inv.w[i];
            PUSH(r);
          } else {
            u256 mask = sub(shl(u256::from_u64(1), bitpos + 1), u256::from_u64(1));
            u256 r;
            for (int i = 0; i < 4; i++) r.w[i] = v.w[i] & mask.w[i];
            PUSH(r);
          }
        } else {
          PUSH(v);
        }
        break;
      }
      case 0x10: { GAS(3); NEED(2); u256 a = pop(), b = pop(); PUSH(u256::from_u64(cmp(a, b) < 0)); break; }
      case 0x11: { GAS(3); NEED(2); u256 a = pop(), b = pop(); PUSH(u256::from_u64(cmp(a, b) > 0)); break; }
      case 0x12: {                                                  // SLT
        GAS(3); NEED(2);
        u256 a = pop(), b = pop();
        bool sa = sign_bit(a), sb = sign_bit(b);
        int c = (sa != sb) ? (sa ? -1 : 1) : cmp(a, b);
        PUSH(u256::from_u64(c < 0));
        break;
      }
      case 0x13: {                                                  // SGT
        GAS(3); NEED(2);
        u256 a = pop(), b = pop();
        bool sa = sign_bit(a), sb = sign_bit(b);
        int c = (sa != sb) ? (sa ? -1 : 1) : cmp(a, b);
        PUSH(u256::from_u64(c > 0));
        break;
      }
      case 0x14: { GAS(3); NEED(2); u256 a = pop(), b = pop(); PUSH(u256::from_u64(eq(a, b))); break; }
      case 0x15: { GAS(3); NEED(1); u256 a = pop(); PUSH(u256::from_u64(a.is_zero())); break; }
      case 0x16: { GAS(3); NEED(2); u256 a = pop(), b = pop(); u256 r; for (int i = 0; i < 4; i++) r.w[i] = a.w[i] & b.w[i]; PUSH(r); break; }
      case 0x17: { GAS(3); NEED(2); u256 a = pop(), b = pop(); u256 r; for (int i = 0; i < 4; i++) r.w[i] = a.w[i] | b.w[i]; PUSH(r); break; }
      case 0x18: { GAS(3); NEED(2); u256 a = pop(), b = pop(); u256 r; for (int i = 0; i < 4; i++) r.w[i] = a.w[i] ^ b.w[i]; PUSH(r); break; }
      case 0x19: { GAS(3); NEED(1); u256 a = pop(); u256 r; for (int i = 0; i < 4; i++) r.w[i] = ~a.w[i]; PUSH(r); break; }
      case 0x1a: {                                                  // BYTE
        GAS(3); NEED(2);
        u256 i = pop(), v = pop();
        if (i.fits_u64() && i.lo64() < 32) {
          uint8_t be[32];
          be_store(v, be);
          PUSH(u256::from_u64(be[i.lo64()]));
        } else PUSH(u256());
        break;
      }
      case 0x1b: { GAS(3); NEED(2); u256 s = pop(), v = pop(); PUSH(s.fits_u64() && s.lo64() < 256 ? shl(v, (unsigned)s.lo64()) : u256()); break; }
      case 0x1c: { GAS(3); NEED(2); u256 s = pop(), v = pop(); PUSH(s.fits_u64() && s.lo64() < 256 ? shr(v, (unsigned)s.lo64()) : u256()); break; }
      case 0x1d: {                                                  // SAR
        GAS(3); NEED(2);
        u256 s = pop(), v = pop();
        bool neg_v = sign_bit(v);
        unsigned sh = (s.fits_u64() && s.lo64() < 256) ? (unsigned)s.lo64() : 256;
        if (sh >= 256) {
          PUSH(neg_v ? sub(u256(), u256::from_u64(1)) : u256());
        } else {
          u256 r = shr(v, sh);
          if (neg_v && sh) {
            u256 ones = sub(u256(), u256::from_u64(1));
            r = add(r, shl(ones, 256 - sh));  // fill high bits
          }
          PUSH(r);
        }
        break;
      }
      case 0x20: {                                                  // KECCAK256
        NEED(2);
        u256 off = pop(), len = pop();
        uint64_t o, l;
        if (!u256_to_u64(off, o) || !u256_to_u64(len, l)) return oog();
        GAS(30 + 6 * ((l + 31) / 32));
        if (!mem.expand(o, l, gas)) return oog();
        uint8_t h[32];
        keccak256(mem.data.data() + o, l, h);
        PUSH(be_load(h));
        break;
      }
      case 0x30: { GAS(2); u256 v = be_load(frame.address.data(), 20); PUSH(v); break; }
      case 0x31: {                                                  // BALANCE
        NEED(1);
        u256 av = pop();
        uint8_t ab[32];
        be_store(av, ab);
        Addr a;
        memcpy(a.data(), ab + 12, 20);
        GAS(evm.warm_account(a) ? G_WARM : G_COLD_ACCOUNT);
        PUSH(evm.load_account(a).balance);
        break;
      }
      case 0x32: { GAS(2); PUSH(be_load(evm.env.origin.data(), 20)); break; } // ORIGIN
      case 0x33: { GAS(2); PUSH(be_load(frame.caller.data(), 20)); break; }  // CALLER
      case 0x34: { GAS(2); PUSH(frame.value); break; }
      case 0x35: {                                                  // CALLDATALOAD
        GAS(3); NEED(1);
        u256 off = pop();
        uint8_t buf[32] = {0};
        if (off.fits_u64()) {
          uint64_t o = off.lo64();
          for (int i = 0; i < 32; i++)
            if (o + i < frame.input.size()) buf[i] = frame.input[o + i];
        }
        PUSH(be_load(buf));
        break;
      }
      case 0x36: { GAS(2); PUSH(u256::from_u64(frame.input.size())); break; }
      case 0x37: {                                                  // CALLDATACOPY
        NEED(3);
        u256 doff = pop(), soff = pop(), len = pop();
        uint64_t d, l;
        if (!u256_to_u64(doff, d) || !u256_to_u64(len, l)) return oog();
        GAS(3 + 3 * ((l + 31) / 32));
        if (!mem.expand(d, l, gas)) return oog();
        for (uint64_t i = 0; i < l; i++) {
          uint64_t s = soff.fits_u64() ? soff.lo64() + i : UINT64_MAX;
          mem.data[d + i] = s < frame.input.size() ? frame.input[s] : 0;
        }
        break;
      }
      case 0x38: { GAS(2); PUSH(u256::from_u64(code.size())); break; }
      case 0x39: {                                                  // CODECOPY
        NEED(3);
        u256 doff = pop(), soff = pop(), len = pop();
        uint64_t d, l;
        if (!u256_to_u64(doff, d) || !u256_to_u64(len, l)) return oog();
        GAS(3 + 3 * ((l + 31) / 32));
        if (!mem.expand(d, l, gas)) return oog();
        for (uint64_t i = 0; i < l; i++) {
          uint64_t s = soff.fits_u64() ? soff.lo64() + i : UINT64_MAX;
          mem.data[d + i] = s < code.size() ? code[s] : 0;
        }
        break;
      }
      case 0x3a: { GAS(2); PUSH(evm.env.gas_price); break; }        // GASPRICE
      case 0x3b: {                                                  // EXTCODESIZE
        NEED(1);
        u256 av = pop();
        uint8_t ab[32];
        be_store(av, ab);
        Addr a;
        memcpy(a.data(), ab + 12, 20);
        GAS(evm.warm_account(a) ? G_WARM : G_COLD_ACCOUNT);
        PUSH(u256::from_u64(evm.load_code(a).size()));
        break;
      }
      case 0x3c: {                                                  // EXTCODECOPY
        NEED(4);
        u256 av = pop(), doff = pop(), soff = pop(), len = pop();
        uint8_t ab[32];
        be_store(av, ab);
        Addr a;
        memcpy(a.data(), ab + 12, 20);
        uint64_t d, l;
        if (!u256_to_u64(doff, d) || !u256_to_u64(len, l)) return oog();
        GAS((evm.warm_account(a) ? G_WARM : G_COLD_ACCOUNT) + 3 * ((l + 31) / 32));
        if (!mem.expand(d, l, gas)) return oog();
        const std::vector<uint8_t>& c = evm.load_code(a);
        for (uint64_t i = 0; i < l; i++) {
          uint64_t s = soff.fits_u64() ? soff.lo64() + i : UINT64_MAX;
          mem.data[d + i] = s < c.size() ? c[s] : 0;
        }
        break;
      }
      case 0x3d: { GAS(2); PUSH(u256::from_u64(retdata.size())); break; }
      case 0x3e: {                                                  // RETURNDATACOPY
        NEED(3);
        u256 doff = pop(), soff = pop(), len = pop();
        uint64_t d, s, l;
        if (!u256_to_u64(doff, d) || !u256_to_u64(len, l) ||
            !u256_to_u64(soff, s)) return oog();
        if (s > retdata.size() || l > retdata.size() - s)
          return oog();   // hard failure per spec
        GAS(3 + 3 * ((l + 31) / 32));
        if (!mem.expand(d, l, gas)) return oog();
        memcpy(mem.data.data() + d, retdata.data() + s, l);
        break;
      }
      case 0x3f: {                                                  // EXTCODEHASH
        NEED(1);
        u256 av = pop();
        uint8_t ab[32];
        be_store(av, ab);
        Addr a;
        memcpy(a.data(), ab + 12, 20);
        GAS(evm.warm_account(a) ? G_WARM : G_COLD_ACCOUNT);
        Account& acc = evm.load_account(a);
        if (!acc.exists) PUSH(u256());
        else PUSH(be_load(acc.code_hash.data()));
        break;
      }
      case 0x40: {                                                  // BLOCKHASH
        GAS(20); NEED(1);
        u256 nv = pop();
        uint8_t out[32] = {0};
        if (nv.fits_u64()) {
          uint64_t n = nv.lo64();
          if (n < evm.env.number && evm.env.number - n <= 256)
            evm.block_hash(n, out);
        }
        PUSH(be_load(out));
        break;
      }
      case 0x41: { GAS(2); PUSH(be_load(evm.env.coinbase.data(), 20)); break; }
      case 0x42: { GAS(2); PUSH(u256::from_u64(evm.env.timestamp)); break; }
      case 0x43: { GAS(2); PUSH(u256::from_u64(evm.env.number)); break; }
      case 0x44: { GAS(2); PUSH(evm.env.prevrandao); break; }
      case 0x45: { GAS(2); PUSH(u256::from_u64(evm.env.gas_limit)); break; }
      case 0x46: { GAS(2); PUSH(u256::from_u64(evm.env.chain_id)); break; }
      case 0x47: { GAS(5); PUSH(evm.load_account(frame.address).balance); break; }
      case 0x48: { GAS(2); PUSH(evm.env.basefee); break; }
      case 0x49: {                                                  // BLOBHASH
        GAS(3); NEED(1);
        u256 i = pop();
        if (i.fits_u64() && (int)i.lo64() < evm.env.n_blob_hashes)
          PUSH(evm.env.blob_hashes[i.lo64()]);
        else PUSH(u256());
        break;
      }
      case 0x4a: { GAS(2); PUSH(evm.env.blob_basefee); break; }
      case 0x50: { GAS(2); NEED(1); pop(); break; }                 // POP
      case 0x51: {                                                  // MLOAD
        NEED(1);
        u256 off = pop();
        uint64_t o;
        if (!u256_to_u64(off, o)) return oog();
        GAS(3);
        if (!mem.expand(o, 32, gas)) return oog();
        PUSH(be_load(mem.data.data() + o));
        break;
      }
      case 0x52: {                                                  // MSTORE
        NEED(2);
        u256 off = pop(), v = pop();
        uint64_t o;
        if (!u256_to_u64(off, o)) return oog();
        GAS(3);
        if (!mem.expand(o, 32, gas)) return oog();
        be_store(v, mem.data.data() + o);
        break;
      }
      case 0x53: {                                                  // MSTORE8
        NEED(2);
        u256 off = pop(), v = pop();
        uint64_t o;
        if (!u256_to_u64(off, o)) return oog();
        GAS(3);
        if (!mem.expand(o, 1, gas)) return oog();
        mem.data[o] = (uint8_t)v.w[0];
        break;
      }
      case 0x54: {                                                  // SLOAD
        NEED(1);
        u256 kv = pop();
        H256 k;
        be_store(kv, k.data());
        GAS(evm.warm_slot(frame.address, k) ? G_WARM : G_COLD_SLOAD);
        PUSH(evm.load_storage(frame.address, k));
        break;
      }
      case 0x55: {                                                  // SSTORE
        if (frame.is_static) return oog();
        NEED(2);
        if (gas <= 2300) return oog();                 // EIP-2200 sentry
        u256 kv = pop(), nv = pop();
        H256 k;
        be_store(kv, k.data());
        bool warm = evm.warm_slot(frame.address, k);
        u256 cur = evm.load_storage(frame.address, k);
        u256 orig = evm.original_of(frame.address, k);
        uint64_t cost = warm ? 0 : G_COLD_SLOAD;
        if (eq(cur, nv)) cost += 100;
        else if (eq(orig, cur)) cost += orig.is_zero() ? 20000 : 2900;
        else cost += 100;
        GAS(cost);
        // EIP-3529 refunds
        if (!eq(cur, nv)) {
          if (eq(orig, cur)) {
            if (!orig.is_zero() && nv.is_zero()) evm.add_refund(4800);
          } else {
            if (!orig.is_zero()) {
              if (cur.is_zero()) evm.add_refund(-4800);
              else if (nv.is_zero()) evm.add_refund(4800);
            }
            if (eq(orig, nv))
              evm.add_refund(orig.is_zero() ? 19900 : 2800);
          }
        }
        evm.set_storage(frame.address, k, nv);
        break;
      }
      case 0x56: {                                                  // JUMP
        GAS(8); NEED(1);
        u256 d = pop();
        if (!d.fits_u64() || d.lo64() >= code.size() ||
            !is_jumpdest[d.lo64()]) return oog();
        pc = d.lo64();
        continue;
      }
      case 0x57: {                                                  // JUMPI
        GAS(10); NEED(2);
        u256 d = pop(), c = pop();
        if (!c.is_zero()) {
          if (!d.fits_u64() || d.lo64() >= code.size() ||
              !is_jumpdest[d.lo64()]) return oog();
          pc = d.lo64();
          continue;
        }
        break;
      }
      case 0x58: { GAS(2); PUSH(u256::from_u64(pc)); break; }
      case 0x59: { GAS(2); PUSH(u256::from_u64(mem.data.size())); break; }
      case 0x5a: { GAS(2); PUSH(u256::from_u64(gas)); break; }
      case 0x5b: { GAS(1); break; }                                 // JUMPDEST
      case 0x5c: {                                                  // TLOAD
        GAS(100); NEED(1);
        u256 kv = pop();
        H256 k;
        be_store(kv, k.data());
        PUSH(evm.tstorage[std::make_pair(frame.address, k)]);
        break;
      }
      case 0x5d: {                                                  // TSTORE
        if (frame.is_static) return oog();
        GAS(100); NEED(2);
        u256 kv = pop(), v = pop();
        H256 k;
        be_store(kv, k.data());
        evm.set_tstorage(frame.address, k, v);
        break;
      }
      case 0x5e: {                                                  // MCOPY
        NEED(3);
        u256 doff = pop(), soff = pop(), len = pop();
        uint64_t d, s, l;
        if (!u256_to_u64(doff, d) || !u256_to_u64(soff, s) ||
            !u256_to_u64(len, l)) return oog();
        GAS(3 + 3 * ((l + 31) / 32));
        if (!mem.expand(d, l, gas) || !mem.expand(s, l, gas)) return oog();
        if (l) memmove(mem.data.data() + d, mem.data.data() + s, l);
        break;
      }
      case 0x5f: { GAS(2); PUSH(u256()); break; }                   // PUSH0
      default:
        if (op >= 0x60 && op <= 0x7f) {                             // PUSHn
          GAS(3);
          int n = op - 0x5f;
          uint8_t buf[32] = {0};
          for (int i = 0; i < n; i++)
            if (pc + 1 + i < code.size()) buf[32 - n + i] = code[pc + 1 + i];
          PUSH(be_load(buf));
          pc += n + 1;
          continue;
        }
        if (op >= 0x80 && op <= 0x8f) {                             // DUPn
          GAS(3);
          unsigned n = op - 0x7f;
          NEED(n);
          PUSH(stack[stack.size() - n]);
          break;
        }
        if (op >= 0x90 && op <= 0x9f) {                             // SWAPn
          GAS(3);
          unsigned n = op - 0x8f;
          NEED(n + 1);
          std::swap(stack[stack.size() - 1], stack[stack.size() - 1 - n]);
          break;
        }
        if (op >= 0xa0 && op <= 0xa4) {                             // LOGn
          if (frame.is_static) return oog();
          int n = op - 0xa0;
          NEED((unsigned)(2 + n));
          u256 off = pop(), len = pop();
          uint64_t o, l;
          if (!u256_to_u64(off, o) || !u256_to_u64(len, l)) return oog();
          GAS(375 + 375 * (uint64_t)n + 8 * l);
          if (!mem.expand(o, l, gas)) return oog();
          LogRec rec;
          rec.addr = frame.address;
          for (int i = 0; i < n; i++) {
            H256 t;
            be_store(pop(), t.data());
            rec.topics.push_back(t);
          }
          rec.data.assign(mem.data.begin() + o, mem.data.begin() + o + l);
          evm.add_log(std::move(rec));
          break;
        }
        switch (op) {
          case 0xf0: case 0xf5: {                                   // CREATE/CREATE2
            if (frame.is_static) return oog();
            bool is2 = op == 0xf5;
            NEED(is2 ? 4u : 3u);
            u256 value = pop(), off = pop(), len = pop();
            u256 salt = is2 ? pop() : u256();
            uint64_t o, l;
            if (!u256_to_u64(off, o) || !u256_to_u64(len, l)) return oog();
            GAS(32000);
            if (!mem.expand(o, l, gas)) return oog();
            uint64_t words = (l + 31) / 32;
            GAS(2 * words + (is2 ? 6 * words : 0));   // EIP-3860 + hash
            if (l > 49152) return oog();              // max initcode
            std::vector<uint8_t> initcode(mem.data.begin() + o,
                                          mem.data.begin() + o + l);
            uint64_t cgas = gas - gas / 64;
            gas -= cgas;
            Addr created{};
            CallResult cr = create(frame.address, value, initcode, cgas,
                                   depth + 1, is2, salt, created);
            gas += cr.gas_left;
            retdata = cr.success ? std::vector<uint8_t>() : cr.output;
            if (cr.success) PUSH(be_load(created.data(), 20));
            else PUSH(u256());
            break;
          }
          case 0xf1: case 0xf2: case 0xf4: case 0xfa: {             // CALLs
            bool has_value = op == 0xf1 || op == 0xf2;
            NEED(has_value ? 7u : 6u);
            u256 gv = pop(), av = pop();
            u256 value = has_value ? pop() : u256();
            u256 ioff = pop(), ilen = pop(), ooff = pop(), olen = pop();
            if (frame.is_static && op == 0xf1 && !value.is_zero()) return oog();
            uint8_t ab[32];
            be_store(av, ab);
            Addr target;
            memcpy(target.data(), ab + 12, 20);
            uint64_t io, il, oo, ol;
            if (!u256_to_u64(ioff, io) || !u256_to_u64(ilen, il) ||
                !u256_to_u64(ooff, oo) || !u256_to_u64(olen, ol)) return oog();
            if (!mem.expand(io, il, gas)) return oog();
            if (!mem.expand(oo, ol, gas)) return oog();
            GAS(evm.warm_account(target) ? G_WARM : G_COLD_ACCOUNT);
            // EIP-7702: execution follows a delegation designator (one
            // hop), charging the delegate's account-access cost
            const std::vector<uint8_t>* tcode = &evm.load_code(target);
            if (evm.env.is_prague && is_delegation(*tcode)) {
              Addr dlg{};
              memcpy(dlg.data(), tcode->data() + 3, 20);
              GAS(evm.warm_account(dlg) ? G_WARM : G_COLD_ACCOUNT);
              tcode = &evm.load_code(dlg);
            }
            uint64_t extra = 0;
            if (!value.is_zero()) {
              extra += 9000;
              Account& tacc = evm.load_account(target);
              if (!tacc.exists && op == 0xf1) extra += 25000;
            }
            GAS(extra);
            uint64_t avail = gas - gas / 64;
            uint64_t cgas = gv.fits_u64() && gv.lo64() < avail ? gv.lo64() : avail;
            gas -= cgas;
            if (!value.is_zero()) cgas += 2300;        // stipend
            std::vector<uint8_t> input(mem.data.begin() + io,
                                       mem.data.begin() + io + il);
            CallResult cr;
            if (depth + 1 > MAX_DEPTH) {
              cr.success = false;
              cr.gas_left = cgas;       // depth failures refund the sub-gas
            } else {
              size_t snap = evm.snapshot();
              size_t log_count = evm.logs.size();
              // value transfer
              bool ok = true;
              if (!value.is_zero() && op == 0xf1) {
                Account& from = evm.load_account(frame.address);
                if (cmp(from.balance, value) < 0) ok = false;
                else {
                  evm.set_balance(frame.address, sub(from.balance, value));
                  Account& to_acc = evm.load_account(target);
                  if (!to_acc.exists) evm.mark_created(target);
                  evm.set_balance(target, add(evm.load_account(target).balance, value));
                }
              }
              if (!ok) {
                cr.success = false;
                cr.gas_left = cgas;
              } else {
                std::vector<uint8_t> pout;
                bool handled = false;
                uint64_t pgas = cgas;
                if (precompile(target, input, pgas, pout, handled) && handled) {
                  cr.success = true;
                  cr.gas_left = pgas;
                  cr.output = std::move(pout);
                } else if (handled) {
                  cr.success = false;
                  cr.gas_left = 0;
                } else {
                  CallFrame sub_frame;
                  sub_frame.caller = frame.address;
                  sub_frame.value = op == 0xf4 ? frame.value : value;
                  sub_frame.input = std::move(input);
                  sub_frame.is_static = frame.is_static || op == 0xfa;
                  sub_frame.code = tcode;
                  if (op == 0xf2 || op == 0xf4) {
                    sub_frame.address = frame.address;   // exec in own ctx
                    if (op == 0xf2) sub_frame.caller = frame.address;
                  } else {
                    sub_frame.address = target;
                  }
                  if (op == 0xf4) sub_frame.caller = frame.caller;
                  cr = call(sub_frame, cgas, depth + 1);
                }
                if (!cr.success) evm.revert_to(snap);
                (void)log_count;
              }
            }
            retdata = cr.output;
            uint64_t copy = std::min<uint64_t>(ol, retdata.size());
            if (copy) memcpy(mem.data.data() + oo, retdata.data(), copy);
            gas += cr.gas_left;
            PUSH(u256::from_u64(cr.success ? 1 : 0));
            break;
          }
          case 0xf3: case 0xfd: {                                   // RETURN/REVERT
            NEED(2);
            u256 off = pop(), len = pop();
            uint64_t o, l;
            if (!u256_to_u64(off, o) || !u256_to_u64(len, l)) return oog();
            if (!mem.expand(o, l, gas)) return oog();
            res.output.assign(mem.data.begin() + o, mem.data.begin() + o + l);
            res.success = op == 0xf3;
            res.gas_left = gas;
            return res;
          }
          case 0xfe:                                                // INVALID
            return oog();
          case 0xff: {                                              // SELFDESTRUCT
            if (frame.is_static) return oog();
            NEED(1);
            u256 av = pop();
            uint8_t ab[32];
            be_store(av, ab);
            Addr beneficiary;
            memcpy(beneficiary.data(), ab + 12, 20);
            GAS(5000);
            if (!evm.warm_account(beneficiary)) GAS(G_COLD_ACCOUNT);
            Account& self = evm.load_account(frame.address);
            u256 bal = self.balance;
            Account& ben = evm.load_account(beneficiary);
            if (!bal.is_zero() && !ben.exists) GAS(25000);
            evm.set_balance(frame.address, u256());
            if (!(beneficiary == frame.address)) {
              if (!evm.load_account(beneficiary).exists && !bal.is_zero())
                evm.mark_created(beneficiary);
              evm.set_balance(beneficiary,
                              add(evm.load_account(beneficiary).balance, bal));
            }
            // EIP-6780: only accounts created in this tx are destroyed
            if (evm.created_this_tx.count(frame.address))
              evm.mark_destroyed(frame.address);
            res.success = true;
            res.gas_left = gas;
            return res;
          }
          default:
            return oog();                                           // unknown
        }
    }
    pc += 1;
  }
  res.success = true;
  res.gas_left = gas;
  return res;
}

#undef NEED
#undef GAS
#undef PUSH

CallResult Interp::create(const Addr& caller, const u256& value,
                          const std::vector<uint8_t>& initcode, uint64_t gas,
                          int depth, bool is_create2, const u256& salt,
                          Addr& out_addr) {
  CallResult res;
  res.gas_left = gas;
  if (depth > MAX_DEPTH) return res;
  Account& cacc = evm.load_account(caller);
  if (cmp(cacc.balance, value) < 0) return res;
  if (cacc.nonce == UINT64_MAX) return res;

  // derive address
  Addr created{};
  if (is_create2) {
    std::vector<uint8_t> buf;
    buf.push_back(0xff);
    buf.insert(buf.end(), caller.begin(), caller.end());
    uint8_t sb[32];
    be_store(salt, sb);
    buf.insert(buf.end(), sb, sb + 32);
    uint8_t ih[32];
    keccak256(initcode.data(), initcode.size(), ih);
    buf.insert(buf.end(), ih, ih + 32);
    uint8_t h[32];
    keccak256(buf.data(), buf.size(), h);
    memcpy(created.data(), h + 12, 20);
  } else {
    // keccak(rlp([caller, nonce]))[12:]
    uint64_t nonce = cacc.nonce;
    std::vector<uint8_t> nb;
    if (nonce) {
      for (int i = 7; i >= 0; i--) {
        uint8_t b = (uint8_t)(nonce >> (8 * i));
        if (b || !nb.empty()) nb.push_back(b);
      }
    }
    std::vector<uint8_t> rlp;
    rlp.push_back(0x80 + 20);
    rlp.insert(rlp.end(), caller.begin(), caller.end());
    if (nb.empty()) rlp.push_back(0x80);
    else if (nb.size() == 1 && nb[0] < 0x80) rlp.push_back(nb[0]);
    else {
      rlp.push_back(0x80 + (uint8_t)nb.size());
      rlp.insert(rlp.end(), nb.begin(), nb.end());
    }
    rlp.insert(rlp.begin(), 0xc0 + (uint8_t)rlp.size());
    uint8_t h[32];
    keccak256(rlp.data(), rlp.size(), h);
    memcpy(created.data(), h + 12, 20);
  }
  out_addr = created;

  evm.set_nonce(caller, cacc.nonce + 1);
  evm.warm_account(created);

  // collision: existing nonce/code means creation fails (consumes gas)
  Account& tacc = evm.load_account(created);
  if (tacc.exists &&
      (tacc.nonce != 0 || tacc.code_hash != EMPTY_CODE_HASH)) {
    res.gas_left = 0;
    return res;
  }

  size_t snap = evm.snapshot();
  evm.mark_created(created);
  evm.set_nonce(created, 1);                       // EIP-161
  if (!value.is_zero()) {
    evm.set_balance(caller, sub(evm.load_account(caller).balance, value));
    evm.set_balance(created, add(evm.load_account(created).balance, value));
  }

  CallFrame frame;
  frame.address = created;
  frame.caller = caller;
  frame.value = value;
  frame.code = &initcode;
  CallResult run = call(frame, gas, depth);
  if (run.success) {
    uint64_t code_gas = 200 * (uint64_t)run.output.size();
    if (run.output.size() > 24576 ||
        (!run.output.empty() && run.output[0] == 0xef) ||
        code_gas > run.gas_left) {
      evm.revert_to(snap);
      res.gas_left = 0;
      return res;
    }
    run.gas_left -= code_gas;
    evm.set_code(created, run.output);
    res.success = true;
    res.gas_left = run.gas_left;
    res.output.clear();
    return res;
  }
  evm.revert_to(snap);
  res.success = false;
  res.gas_left = run.gas_left;
  res.output = std::move(run.output);     // revert data
  return res;
}

// precompiles 0x1..0x0a. Returns success; sets handled=true when the
// address is a precompile. bn128 pairing (0x8) and the KZG point-eval
// (0x0a) are not implemented natively: they set evm.error so the host
// can reject the block loudly instead of silently mis-executing.
bool Interp::precompile(const Addr& a, const std::vector<uint8_t>& input,
                        uint64_t& gas, std::vector<uint8_t>& out,
                        bool& handled) {
  handled = false;
  for (int i = 0; i < 19; i++)
    if (a[i]) return false;
  uint8_t id = a[19];
  uint8_t hi = evm.env.is_prague ? 0x11 : 0x0a;
  if (id == 0 || id > hi) return false;
  handled = true;
  auto take = [&](uint64_t need) {
    if (need > gas) return false;
    gas -= need;
    return true;
  };
  switch (id) {
    case 0x1: {                                                    // ecrecover
      if (!take(3000)) return false;
      uint8_t buf[128] = {0};
      memcpy(buf, input.data(), std::min<size_t>(input.size(), 128));
      u256 v = be_load(buf + 32);
      if (!v.fits_u64() || (v.lo64() != 27 && v.lo64() != 28)) {
        out.clear();
        return true;
      }
      uint8_t addr[20];
      if (ecrecover(buf, buf + 64, buf + 96, (int)(v.lo64() - 27), addr)) {
        out.assign(32, 0);
        memcpy(out.data() + 12, addr, 20);
      } else {
        out.clear();
      }
      return true;
    }
    case 0x2: {                                                    // sha256
      uint64_t words = (input.size() + 31) / 32;
      if (!take(60 + 12 * words)) return false;
      out.resize(32);
      sha256(input.data(), input.size(), out.data());
      return true;
    }
    case 0x3: {                                                    // ripemd160
      uint64_t words = (input.size() + 31) / 32;
      if (!take(600 + 120 * words)) return false;
      out.assign(32, 0);
      ripemd160(input.data(), input.size(), out.data() + 12);
      return true;
    }
    case 0x4: {                                                    // identity
      uint64_t words = (input.size() + 31) / 32;
      if (!take(15 + 3 * words)) return false;
      out = input;
      return true;
    }
    case 0x5: {                                                    // modexp
      uint8_t head[96] = {0};
      memcpy(head, input.data(), std::min<size_t>(input.size(), 96));
      u256 bl = be_load(head), el = be_load(head + 32), ml = be_load(head + 64);
      if (!bl.fits_u64() || !el.fits_u64() || !ml.fits_u64()) return false;
      uint64_t blen = bl.lo64(), elen = el.lo64(), mlen = ml.lo64();
      if (blen > 1024 || elen > 1024 || mlen > 1024) return false;
      // EIP-2565 gas
      uint64_t maxlen = std::max(blen, mlen);
      uint64_t words = (maxlen + 7) / 8;
      uint64_t mult = words * words;
      auto get = [&](size_t off, size_t len, std::vector<uint8_t>& dst) {
        dst.assign(len, 0);
        for (size_t i = 0; i < len; i++)
          if (96 + off + i < input.size()) dst[i] = input[96 + off + i];
      };
      std::vector<uint8_t> bb, ee, mm;
      get(0, blen, bb);
      get(blen, elen, ee);
      get(blen + elen, mlen, mm);
      uint64_t ebits = 0;
      size_t first = 0;
      while (first < ee.size() && ee[first] == 0) first++;
      if (first < ee.size()) {
        size_t tail = ee.size() - first - 1;
        uint8_t top = ee[first];
        int tb = 0;
        while (top) { tb++; top >>= 1; }
        ebits = 8 * tail + (tb ? tb - 1 : 0);
      }
      uint64_t iter = std::max<uint64_t>(ebits, 1);
      if (elen > 32) iter = std::max<uint64_t>(8 * (elen - 32) + ebits, 1);
      uint64_t cost = std::max<uint64_t>(200, mult * iter / 3);
      if (!take(cost)) return false;
      // big modexp over byte vectors (simple square-and-multiply on a
      // byte-limb representation; sizes are <= 1024 bytes)
      auto to_bits = [](const std::vector<uint8_t>& v) {
        std::vector<bool> bits;
        for (uint8_t byte : v)
          for (int i = 7; i >= 0; i--) bits.push_back((byte >> i) & 1);
        return bits;
      };
      // modular arithmetic on byte vectors (big-endian)
      auto bcmp = [](const std::vector<uint8_t>& x, const std::vector<uint8_t>& y) {
        size_t nx = x.size(), ny = y.size();
        size_t n = std::max(nx, ny);
        for (size_t i = 0; i < n; i++) {
          uint8_t xb = i + nx >= n ? x[i - (n - nx)] : 0;
          uint8_t yb = i + ny >= n ? y[i - (n - ny)] : 0;
          if (xb != yb) return xb < yb ? -1 : 1;
        }
        return 0;
      };
      auto bsub = [](std::vector<uint8_t>& x, const std::vector<uint8_t>& y) {
        int borrow = 0;
        size_t nx = x.size(), ny = y.size();
        for (size_t i = 0; i < nx; i++) {
          int xi = x[nx - 1 - i];
          int yi = i < ny ? y[ny - 1 - i] : 0;
          int d = xi - yi - borrow;
          borrow = d < 0;
          x[nx - 1 - i] = (uint8_t)(d + (borrow ? 256 : 0));
        }
      };
      auto bmod = [&](std::vector<uint8_t>& x, const std::vector<uint8_t>& m) {
        // shift-subtract reduction
        if (bcmp(x, m) < 0) return;
        // find shift
        std::vector<uint8_t> mm2 = m;
        std::vector<std::vector<uint8_t>> shifts;
        std::vector<uint8_t> cur = m;
        while (bcmp(cur, x) <= 0) {
          shifts.push_back(cur);
          // cur <<= 1
          std::vector<uint8_t> nxt(cur.size() + 1, 0);
          int carry = 0;
          for (size_t i = 0; i < cur.size(); i++) {
            int v = (cur[cur.size() - 1 - i] << 1) | carry;
            nxt[nxt.size() - 1 - i] = (uint8_t)v;
            carry = v >> 8;
          }
          nxt[0] = (uint8_t)carry;
          cur = nxt;
          if (shifts.size() > 8300) break;
        }
        for (auto it = shifts.rbegin(); it != shifts.rend(); ++it)
          if (bcmp(x, *it) >= 0) bsub(x, *it);
      };
      auto bmul = [&](const std::vector<uint8_t>& x, const std::vector<uint8_t>& y) {
        std::vector<uint32_t> t(x.size() + y.size(), 0);
        for (size_t i = 0; i < x.size(); i++)
          for (size_t j = 0; j < y.size(); j++) {
            size_t pos = t.size() - 1 - ((x.size() - 1 - i) + (y.size() - 1 - j));
            uint32_t v = t[pos] + (uint32_t)x[i] * y[j];
            t[pos] = v & 0xFF;
            uint32_t c = v >> 8;
            size_t p = pos;
            while (c && p > 0) {
              p--;
              uint32_t v2 = t[p] + c;
              t[p] = v2 & 0xFF;
              c = v2 >> 8;
            }
          }
        std::vector<uint8_t> r(t.size());
        for (size_t i = 0; i < t.size(); i++) r[i] = (uint8_t)t[i];
        return r;
      };
      out.assign(mlen, 0);
      bool mzero = true;
      for (uint8_t b : mm) mzero &= b == 0;
      if (mlen == 0) return true;
      if (mzero) return true;
      std::vector<uint8_t> base = bb;
      bmod(base, mm);
      std::vector<uint8_t> r{1};
      std::vector<bool> ebitsv = to_bits(ee);
      for (bool bit : ebitsv) {
        r = bmul(r, r);
        bmod(r, mm);
        if (bit) {
          r = bmul(r, base);
          bmod(r, mm);
        }
      }
      // right-align into mlen bytes
      size_t nz = 0;
      while (nz < r.size() && r[nz] == 0) nz++;
      size_t rl = r.size() - nz;
      if (rl <= mlen) memcpy(out.data() + mlen - rl, r.data() + nz, rl);
      return true;
    }
    case 0x6: {                                                    // bn add
      if (!take(150)) return false;
      uint8_t buf[128] = {0};
      memcpy(buf, input.data(), std::min<size_t>(input.size(), 128));
      BnPt P1{be_load(buf), be_load(buf + 32), false};
      BnPt P2{be_load(buf + 64), be_load(buf + 96), false};
      if (P1.x.is_zero() && P1.y.is_zero()) P1.inf = true;
      if (P2.x.is_zero() && P2.y.is_zero()) P2.inf = true;
      if (!bn_on_curve(P1) || !bn_on_curve(P2)) return false;
      BnPt R = bn_add(P1, P2);
      out.assign(64, 0);
      if (!R.inf) {
        be_store(R.x, out.data());
        be_store(R.y, out.data() + 32);
      }
      return true;
    }
    case 0x7: {                                                    // bn mul
      if (!take(6000)) return false;
      uint8_t buf[96] = {0};
      memcpy(buf, input.data(), std::min<size_t>(input.size(), 96));
      BnPt P{be_load(buf), be_load(buf + 32), false};
      if (P.x.is_zero() && P.y.is_zero()) P.inf = true;
      if (!bn_on_curve(P)) return false;
      u256 k = be_load(buf + 64);
      BnPt R = bn_mul(P, k);
      out.assign(64, 0);
      if (!R.inf) {
        be_store(R.x, out.data());
        be_store(R.y, out.data() + 32);
      }
      return true;
    }
    case 0x8: {                                                    // bn pairing
      if (!evm.pairing_check) {
        evm.error = "bn254 pairing precompile not supported";
        return false;
      }
      if (input.size() % 192 != 0) return false;
      uint64_t k = input.size() / 192;
      if (!take(45000 + 34000 * k)) return false;
      int r = evm.pairing_check(input.data(), input.size());
      if (r < 0) return false;
      out.assign(32, 0);
      out[31] = (uint8_t)r;
      return true;
    }
    case 0x9: {                                                    // blake2f
      if (input.size() != 213) return false;
      uint32_t rounds = (input[0] << 24) | (input[1] << 16) |
                        (input[2] << 8) | input[3];
      if (!take(rounds)) return false;
      uint64_t h[8], m[16], t[2];
      memcpy(h, input.data() + 4, 64);
      memcpy(m, input.data() + 68, 128);
      memcpy(t, input.data() + 196, 16);
      uint8_t fflag = input[212];
      if (fflag > 1) return false;
      static const uint8_t SIG[10][16] = {
        {0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15},
        {14,10,4,8,9,15,13,6,1,12,0,2,11,7,5,3},
        {11,8,12,0,5,2,15,13,10,14,3,6,7,1,9,4},
        {7,9,3,1,13,12,11,14,2,6,5,10,4,0,15,8},
        {9,0,5,7,2,4,10,15,14,1,11,12,6,8,3,13},
        {2,12,6,10,0,11,8,3,4,13,7,5,15,14,1,9},
        {12,5,1,15,14,13,4,10,0,7,6,3,9,2,8,11},
        {13,11,7,14,12,1,3,9,5,0,15,4,8,6,2,10},
        {6,15,14,9,11,3,0,8,12,2,13,7,1,4,10,5},
        {10,2,8,4,7,6,1,5,15,11,9,14,3,12,13,0}};
      static const uint64_t IV[8] = {
        0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
        0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
        0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
      uint64_t v[16];
      memcpy(v, h, 64);
      memcpy(v + 8, IV, 64);
      v[12] ^= t[0];
      v[13] ^= t[1];
      if (fflag) v[14] = ~v[14];
      auto G = [&](int a, int b, int c, int d, uint64_t x, uint64_t y) {
        v[a] = v[a] + v[b] + x;
        v[d] = rotl64(v[d] ^ v[a], 32);
        v[c] = v[c] + v[d];
        v[b] = rotl64(v[b] ^ v[c], 40);
        v[a] = v[a] + v[b] + y;
        v[d] = rotl64(v[d] ^ v[a], 48);
        v[c] = v[c] + v[d];
        v[b] = rotl64(v[b] ^ v[c], 1);
      };
      for (uint32_t r = 0; r < rounds; r++) {
        const uint8_t* s = SIG[r % 10];
        G(0, 4, 8, 12, m[s[0]], m[s[1]]);
        G(1, 5, 9, 13, m[s[2]], m[s[3]]);
        G(2, 6, 10, 14, m[s[4]], m[s[5]]);
        G(3, 7, 11, 15, m[s[6]], m[s[7]]);
        G(0, 5, 10, 15, m[s[8]], m[s[9]]);
        G(1, 6, 11, 12, m[s[10]], m[s[11]]);
        G(2, 7, 8, 13, m[s[12]], m[s[13]]);
        G(3, 4, 9, 14, m[s[14]], m[s[15]]);
      }
      for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[i + 8];
      out.resize(64);
      memcpy(out.data(), h, 64);
      return true;
    }
    case 0x0a: {                                                   // KZG
      if (!evm.kzg_verify) {
        evm.error = "KZG point-evaluation precompile not supported";
        return false;
      }
      if (!take(50000)) return false;
      if (input.size() != 192) return false;
      int r = evm.kzg_verify(input.data());
      if (r < 0) {
        evm.error = "KZG trusted setup not provisioned";
        return false;
      }
      if (r == 0) return false;
      // U256(FIELD_ELEMENTS_PER_BLOB = 4096) ++ U256(BLS_MODULUS)
      static const uint8_t BLS_MOD[32] = {
        0x73, 0xed, 0xa7, 0x53, 0x29, 0x9d, 0x7d, 0x48,
        0x33, 0x39, 0xd8, 0x08, 0x09, 0xa1, 0xd8, 0x05,
        0x53, 0xbd, 0xa4, 0x02, 0xff, 0xfe, 0x5b, 0xfe,
        0xff, 0xff, 0xff, 0xff, 0x00, 0x00, 0x00, 0x01};
      out.assign(64, 0);
      out[30] = 0x10;            // 4096
      memcpy(out.data() + 32, BLS_MOD, 32);
      return true;
    }
    // EIP-2537 BLS12-381 suite (Prague, 0x0b..0x11): curve math runs in
    // the host callback (app/bls12381.py; in-guest via SYS_BIGINT);
    // the engine meters gas and validates input lengths.
    case 0x0b: case 0x0c: case 0x0d: case 0x0e:
    case 0x0f: case 0x10: case 0x11: {
      if (!evm.bls_op) {
        evm.error = "BLS12-381 precompiles not supported";
        return false;
      }
      int op = id - 0x0b;
      uint64_t len = input.size();
      uint64_t need = 0;
      switch (id) {
        case 0x0b:                                                 // G1 add
          if (len != 256) return false;
          need = 375;
          break;
        case 0x0c:                                                 // G1 msm
          if (len == 0 || len % 160 != 0) return false;
          need = bls_msm_gas(len / 160, 12000, BLS_G1_DISCOUNT);
          break;
        case 0x0d:                                                 // G2 add
          if (len != 512) return false;
          need = 600;
          break;
        case 0x0e:                                                 // G2 msm
          if (len == 0 || len % 288 != 0) return false;
          need = bls_msm_gas(len / 288, 22500, BLS_G2_DISCOUNT);
          break;
        case 0x0f:                                                 // pairing
          if (len == 0 || len % 384 != 0) return false;
          need = 32600 * (len / 384) + 37700;
          break;
        case 0x10:                                                 // map fp
          if (len != 64) return false;
          need = 5500;
          break;
        case 0x11:                                                 // map fp2
          if (len != 128) return false;
          need = 23800;
          break;
      }
      if (!take(need)) return false;
      uint8_t buf[256];
      uint64_t outlen = 0;
      int r = evm.bls_op(op, input.data(), len, buf, &outlen);
      if (r < 0) {
        evm.error = "BLS12-381 backend error";
        return false;
      }
      if (r == 0 || outlen > 256) return false;
      out.assign(buf, buf + outlen);
      return true;
    }
  }
  return false;
}

// blake2 rotr is actually rotation right; fix via rotl64 with adjusted
// amounts above (32, 24, 16, 63 right = 32, 40, 48, 1 left).

}  // namespace

// ===========================================================================
// C API (ctypes)
// ===========================================================================

extern "C" {

void* evm_create(cb_get_account ga, cb_get_code gc, cb_get_storage gs,
                 cb_block_hash bh) {
  Evm* e = new Evm();
  e->get_account = ga;
  e->get_code = gc;
  e->get_storage = gs;
  e->block_hash = bh;
  return e;
}

void evm_destroy(void* h) { delete (Evm*)h; }

void evm_set_pairing_cb(void* h, cb_pairing cb) {
  ((Evm*)h)->pairing_check = cb;
}

void evm_set_kzg_cb(void* h, cb_kzg cb) {
  ((Evm*)h)->kzg_verify = cb;
}

void evm_set_bls_cb(void* h, cb_bls cb) { ((Evm*)h)->bls_op = cb; }

// fork switches beyond the Cancun default (host-driven, per block)
void evm_set_fork(void* h, int is_prague) {
  ((Evm*)h)->env.is_prague = is_prague != 0;
}

void evm_set_block(void* h, const uint8_t* coinbase, uint64_t number,
                   uint64_t timestamp, uint64_t gas_limit,
                   const uint8_t* basefee, const uint8_t* prevrandao,
                   const uint8_t* blob_basefee, uint64_t chain_id) {
  Evm* e = (Evm*)h;
  memcpy(e->env.coinbase.data(), coinbase, 20);
  e->env.number = number;
  e->env.timestamp = timestamp;
  e->env.gas_limit = gas_limit;
  e->env.basefee = be_load(basefee);
  e->env.prevrandao = be_load(prevrandao);
  e->env.blob_basefee = be_load(blob_basefee);
  e->env.chain_id = chain_id;
}

// direct balance/nonce/code mutation (withdrawals, system accounts)
void evm_add_balance(void* h, const uint8_t* addr, const uint8_t* amount) {
  Evm* e = (Evm*)h;
  Addr a;
  memcpy(a.data(), addr, 20);
  u256 v = be_load(amount);
  Account& acc = e->load_account(a);
  if (!acc.exists && !v.is_zero()) e->mark_created(a);
  e->set_balance(a, add(e->load_account(a).balance, v));
}

// Execute one transaction. to == NULL -> contract creation.
// access_list: packed [addr(20) | n_slots(u32 LE) | slots(32 each)]*.
// Returns 1 on success, 0 on revert/failure, -1 on invalid tx
// (insufficient balance / nonce mismatch / intrinsic gas), -2 on an
// unsupported-precompile error (host must reject the block).
// auth_list (EIP-7702, Prague): n_auth packed 125-byte entries
// [chain_id(32 BE) | address(20) | nonce(8 LE) | y_parity(1) | r(32) | s(32)]
int evm_exec_tx(void* h, const uint8_t* from, const uint8_t* to,
                const uint8_t* value32, uint64_t gas_limit,
                const uint8_t* eff_gas_price, const uint8_t* tip_per_gas,
                const uint8_t* data, uint64_t data_len,
                const uint8_t* access_list, uint64_t acl_len,
                const uint8_t* blob_hashes, uint64_t n_blobs,
                const uint8_t* blob_fee, uint64_t tx_nonce,
                const uint8_t* auth_list, uint64_t n_auth,
                uint64_t* out_gas_used, uint8_t* out_created /*20*/) {
  Evm* e = (Evm*)h;
  e->error.clear();
  // per-tx resets
  e->warm_accounts.clear();
  e->warm_slots.clear();
  e->tstorage.clear();
  e->original_storage.clear();
  e->created_this_tx.clear();
  e->refund = 0;
  e->journal.clear();

  Addr sender{};
  memcpy(sender.data(), from, 20);
  u256 value = be_load(value32);
  u256 price = be_load(eff_gas_price);
  u256 tip = be_load(tip_per_gas);
  e->env.origin = sender;
  e->env.gas_price = price;
  e->env.n_blob_hashes = (int)std::min<uint64_t>(n_blobs, 8);
  for (int i = 0; i < e->env.n_blob_hashes; i++)
    e->env.blob_hashes[i] = be_load(blob_hashes + 32 * i);

  // intrinsic gas
  bool is_create = to == nullptr;
  uint64_t intrinsic = 21000 + (is_create ? 32000 : 0);
  for (uint64_t i = 0; i < data_len; i++)
    intrinsic += data[i] ? 16 : 4;
  if (is_create) intrinsic += 2 * ((data_len + 31) / 32);   // EIP-3860
  // access list: parse + warm
  uint64_t off = 0;
  uint64_t n_acl_addr = 0, n_acl_slot = 0;
  std::vector<std::pair<Addr, std::vector<H256>>> acl;
  while (off + 24 <= acl_len) {
    Addr a;
    memcpy(a.data(), access_list + off, 20);
    uint32_t ns;
    memcpy(&ns, access_list + off + 20, 4);
    off += 24;
    std::vector<H256> slots;
    for (uint32_t i = 0; i < ns && off + 32 <= acl_len; i++) {
      H256 k;
      memcpy(k.data(), access_list + off, 32);
      off += 32;
      slots.push_back(k);
    }
    n_acl_addr++;
    n_acl_slot += slots.size();
    acl.emplace_back(a, std::move(slots));
  }
  intrinsic += 2400 * n_acl_addr + 1900 * n_acl_slot;
  // EIP-7702: PER_EMPTY_ACCOUNT_COST per authorization upfront
  if (n_auth && !e->env.is_prague) return -1;
  intrinsic += 25000 * n_auth;
  if (intrinsic > gas_limit) return -1;
  // EIP-7623 calldata floor (Prague): tokens = zeros + 4*nonzeros
  uint64_t floor_gas = 0;
  if (e->env.is_prague) {
    uint64_t tokens = 0;
    for (uint64_t i = 0; i < data_len; i++) tokens += data[i] ? 4 : 1;
    floor_gas = 21000 + 10 * tokens;
    if (floor_gas > gas_limit) return -1;
  }

  // nonce + upfront balance
  Account& sacc = e->load_account(sender);
  if (sacc.nonce != tx_nonce) return -1;
  u256 upfront = add(mul(u256::from_u64(gas_limit), price), value);
  u256 bfee = be_load(blob_fee);
  upfront = add(upfront, bfee);
  if (cmp(sacc.balance, upfront) < 0) return -1;
  e->set_balance(sender, sub(sacc.balance,
                             add(mul(u256::from_u64(gas_limit), price), bfee)));
  e->set_nonce(sender, sacc.nonce + 1);

  // warm sets: origin, target, coinbase, precompiles, access list
  e->warm_account(sender);
  e->warm_account(e->env.coinbase);
  for (uint8_t i = 1; i <= (e->env.is_prague ? 0x11 : 0x0a); i++) {
    Addr p{};
    p[19] = i;
    e->warm_account(p);
  }
  for (auto& [a, slots] : acl) {
    e->warm_account(a);
    for (auto& k : slots) e->warm_slot(a, k);
  }

  // EIP-7702 authorization-list processing (after the sender nonce
  // bump, before execution; invalid tuples are skipped, not fatal)
  if (n_auth && e->env.is_prague) {
    static const u256 SECP_N_HALF = shr(SECP_N, 1);
    for (uint64_t ai = 0; ai < n_auth; ai++) {
      const uint8_t* p = auth_list + 125 * ai;
      u256 a_chain = be_load(p);
      const uint8_t* a_addr = p + 32;
      uint64_t a_nonce;
      memcpy(&a_nonce, p + 52, 8);
      uint8_t yp = p[60];
      const uint8_t* sig_r = p + 61;
      const uint8_t* sig_s = p + 93;
      if (!a_chain.is_zero() &&
          !(a_chain.fits_u64() && a_chain.lo64() == e->env.chain_id))
        continue;
      if (a_nonce == UINT64_MAX || yp > 1) continue;
      if (cmp(be_load(sig_s), SECP_N_HALF) > 0) continue;
      // authority = ecrecover(keccak(0x05 || rlp([chain_id, addr, nonce])))
      std::vector<uint8_t> payload;
      rlp_put_int(payload, a_chain);
      rlp_put_bytes(payload, a_addr, 20);
      rlp_put_int(payload, u256::from_u64(a_nonce));
      std::vector<uint8_t> msg;
      msg.push_back(0x05);
      rlp_wrap_list(msg, payload);
      uint8_t digest[32];
      keccak256(msg.data(), msg.size(), digest);
      uint8_t rec[20];
      if (!ecrecover(digest, sig_r, sig_s, yp, rec)) continue;
      Addr authority{};
      memcpy(authority.data(), rec, 20);
      e->warm_account(authority);
      const std::vector<uint8_t>& acode = e->load_code(authority);
      if (!acode.empty() && !is_delegation(acode)) continue;
      Account& acc = e->load_account(authority);
      if (acc.nonce != a_nonce) continue;
      bool is_empty = !acc.exists || (acc.nonce == 0 &&
                                      acc.balance.is_zero() &&
                                      acode.empty());
      if (!is_empty) e->add_refund(25000 - 12500);
      bool clearing = true;
      for (int i = 0; i < 20; i++)
        if (a_addr[i]) clearing = false;
      if (clearing) {
        e->set_code(authority, {});
      } else {
        std::vector<uint8_t> d = {0xef, 0x01, 0x00};
        d.insert(d.end(), a_addr, a_addr + 20);
        e->set_code(authority, std::move(d));
      }
      if (!acc.exists) e->mark_created(authority);
      e->set_nonce(authority, e->load_account(authority).nonce + 1);
    }
  }

  uint64_t gas = gas_limit - intrinsic;
  Interp interp(*e);
  CallResult cr;
  Addr created{};
  std::vector<uint8_t> input(data, data + data_len);
  if (is_create) {
    cr = interp.create(sender, value, input, gas, 1, false, u256(), created);
    if (out_created) memcpy(out_created, created.data(), 20);
  } else {
    Addr target{};
    memcpy(target.data(), to, 20);
    e->warm_account(target);
    size_t snap = e->snapshot();
    // value transfer
    Account& sa2 = e->load_account(sender);
    if (cmp(sa2.balance, value) < 0) {
      cr.success = false;
      cr.gas_left = gas;
    } else {
      e->set_balance(sender, sub(sa2.balance, value));
      Account& ta = e->load_account(target);
      if (!ta.exists && !value.is_zero()) e->mark_created(target);
      e->set_balance(target, add(e->load_account(target).balance, value));
      std::vector<uint8_t> pout;
      bool handled = false;
      uint64_t pgas = gas;
      if (interp.precompile(target, input, pgas, pout, handled) && handled) {
        cr.success = true;
        cr.gas_left = pgas;
        cr.output = std::move(pout);
      } else if (handled) {
        cr.success = false;
        cr.gas_left = 0;
      } else {
        CallFrame frame;
        frame.address = target;
        frame.caller = sender;
        frame.value = value;
        frame.input = std::move(input);
        const std::vector<uint8_t>* tcode = &e->load_code(target);
        bool dlg_oog = false;
        if (e->env.is_prague && is_delegation(*tcode)) {
          // EIP-7702: top-level execution follows the designator
          Addr dlg{};
          memcpy(dlg.data(), tcode->data() + 3, 20);
          uint64_t need = e->warm_account(dlg) ? G_WARM : G_COLD_ACCOUNT;
          if (need > gas) {
            dlg_oog = true;
          } else {
            gas -= need;
            tcode = &e->load_code(dlg);
          }
        }
        frame.code = tcode;
        if (dlg_oog) {
          cr.success = false;
          cr.gas_left = 0;
        } else {
          cr = interp.call(frame, gas, 1);
        }
      }
      if (!cr.success) e->revert_to(snap);
    }
  }
  if (!e->error.empty()) return -2;

  uint64_t used = gas_limit - cr.gas_left;
  uint64_t refund = std::min(e->refund, used / 5);
  if (cr.success) used -= refund;
  if (used < floor_gas) used = floor_gas;    // EIP-7623 calldata floor
  // gas refund to sender; tip to coinbase (basefee burned)
  e->set_balance(sender, add(e->load_account(sender).balance,
                             mul(u256::from_u64(gas_limit - used), price)));
  e->set_balance(e->env.coinbase,
                 add(e->load_account(e->env.coinbase).balance,
                     mul(u256::from_u64(used), tip)));
  // EIP-6780 destroyed accounts vanish
  for (const Addr& a : e->destroyed) {
    Account& acc = e->load_account(a);
    acc.exists = false;
    acc.nonce = 0;
    acc.balance = u256();
    acc.code_hash = EMPTY_CODE_HASH;
    acc.code.clear();
  }
  e->destroyed.clear();
  *out_gas_used = used;
  return cr.success ? 1 : 0;
}

const char* evm_last_error(void* h) { return ((Evm*)h)->error.c_str(); }

// Protocol system call (EIP-4788 beacon root etc.): executes `to` with
// the system sender, 30M gas, no fee/nonce/coinbase effects; state
// changes commit, output/logs are discarded. No-op if `to` has no code.
void evm_system_call(void* h, const uint8_t* to, const uint8_t* data,
                     uint64_t data_len) {
  Evm* e = (Evm*)h;
  Addr target{};
  memcpy(target.data(), to, 20);
  const std::vector<uint8_t>& code = e->load_code(target);
  if (code.empty()) return;
  e->warm_accounts.clear();
  e->warm_slots.clear();
  e->tstorage.clear();
  e->original_storage.clear();
  e->created_this_tx.clear();
  e->refund = 0;
  e->journal.clear();
  Addr sys{};
  static const uint8_t SYSTEM[20] = {0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                                     0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                                     0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                                     0xff, 0xfe};
  memcpy(sys.data(), SYSTEM, 20);
  e->env.origin = sys;
  e->env.gas_price = u256();
  CallFrame frame;
  frame.address = target;
  frame.caller = sys;
  frame.input.assign(data, data + data_len);
  frame.code = &code;
  Interp interp(*e);
  size_t snap = e->snapshot();
  size_t nlogs = e->logs.size();
  CallResult cr = interp.call(frame, 30000000, 1);
  if (!cr.success) e->revert_to(snap);
  e->logs.resize(nlogs);          // system-call logs are not receipts
}

// System call that CAPTURES output (EIP-7002 withdrawal / EIP-7251
// consolidation request contracts). Returns the output length (copied
// into out up to cap), -1 if the target has no code (the host must then
// fail the block per those EIPs), -2 if the call did not succeed.
int64_t evm_system_call_out(void* h, const uint8_t* to, const uint8_t* data,
                            uint64_t data_len, uint8_t* out, uint64_t cap) {
  Evm* e = (Evm*)h;
  Addr target{};
  memcpy(target.data(), to, 20);
  const std::vector<uint8_t>& code = e->load_code(target);
  if (code.empty()) return -1;
  e->warm_accounts.clear();
  e->warm_slots.clear();
  e->tstorage.clear();
  e->original_storage.clear();
  e->created_this_tx.clear();
  e->refund = 0;
  e->journal.clear();
  Addr sys{};
  static const uint8_t SYSTEM[20] = {0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                                     0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                                     0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                                     0xff, 0xfe};
  memcpy(sys.data(), SYSTEM, 20);
  e->env.origin = sys;
  e->env.gas_price = u256();
  CallFrame frame;
  frame.address = target;
  frame.caller = sys;
  frame.input.assign(data, data + data_len);
  frame.code = &code;
  Interp interp(*e);
  size_t snap = e->snapshot();
  size_t nlogs = e->logs.size();
  CallResult cr = interp.call(frame, 30000000, 1);
  e->logs.resize(nlogs);          // system-call logs are not receipts
  if (!cr.success) {
    e->revert_to(snap);
    return -2;
  }
  uint64_t n = std::min<uint64_t>(cr.output.size(), cap);
  if (n) memcpy(out, cr.output.data(), n);
  return (int64_t)cr.output.size();
}

// -- logs (collected across the whole block; host drains per tx) -----------

uint64_t evm_log_count(void* h) { return ((Evm*)h)->logs.size(); }

// serialize log i: [addr(20) | n_topics(u32) | topics | data_len(u32) | data]
uint64_t evm_get_log(void* h, uint64_t i, uint8_t* buf, uint64_t cap) {
  Evm* e = (Evm*)h;
  if (i >= e->logs.size()) return 0;
  const LogRec& L = e->logs[i];
  uint64_t need = 20 + 4 + 32 * L.topics.size() + 4 + L.data.size();
  if (cap < need) return need;
  uint8_t* p = buf;
  memcpy(p, L.addr.data(), 20);
  p += 20;
  uint32_t nt = (uint32_t)L.topics.size();
  memcpy(p, &nt, 4);
  p += 4;
  for (const H256& t : L.topics) {
    memcpy(p, t.data(), 32);
    p += 32;
  }
  uint32_t nd = (uint32_t)L.data.size();
  memcpy(p, &nd, 4);
  p += 4;
  memcpy(p, L.data.data(), L.data.size());
  return need;
}

void evm_clear_logs(void* h) { ((Evm*)h)->logs.clear(); }

// -- state diff extraction (end of block) -----------------------------------

uint64_t evm_touched_accounts(void* h, uint8_t* addrs, uint64_t cap) {
  Evm* e = (Evm*)h;
  uint64_t n = 0;
  for (auto& kv : e->accounts) {
    if (addrs && n < cap) memcpy(addrs + 20 * n, kv.first.data(), 20);
    n++;
  }
  return n;
}

int evm_account_state(void* h, const uint8_t* addr, uint64_t* nonce,
                      uint8_t* balance, uint8_t* code_hash,
                      uint64_t* code_len) {
  Evm* e = (Evm*)h;
  Addr a;
  memcpy(a.data(), addr, 20);
  Account& acc = e->load_account(a);
  *nonce = acc.nonce;
  be_store(acc.balance, balance);
  memcpy(code_hash, acc.code_hash.data(), 32);
  *code_len = acc.loaded_code ? acc.code.size() : 0;
  return acc.exists ? 1 : 0;
}

uint64_t evm_account_code(void* h, const uint8_t* addr, uint8_t* buf,
                          uint64_t cap) {
  Evm* e = (Evm*)h;
  Addr a;
  memcpy(a.data(), addr, 20);
  const std::vector<uint8_t>& c = e->load_code(a);
  uint64_t n = std::min<uint64_t>(c.size(), cap);
  memcpy(buf, c.data(), n);
  return c.size();
}

// storage entries touched: [addr(20) | key(32) | value(32)]*
uint64_t evm_touched_storage(void* h, uint8_t* buf, uint64_t cap) {
  Evm* e = (Evm*)h;
  uint64_t n = 0;
  for (auto& kv : e->storage) {
    if (buf && n < cap) {
      uint8_t* p = buf + 84 * n;
      memcpy(p, kv.first.first.data(), 20);
      memcpy(p + 20, kv.first.second.data(), 32);
      be_store(kv.second, p + 52);
    }
    n++;
  }
  return n;
}

// standalone helpers for the host
void evm_keccak256(const uint8_t* data, uint64_t len, uint8_t* out) {
  keccak256(data, len, out);
}

int evm_ecrecover(const uint8_t* hash, const uint8_t* r, const uint8_t* s,
                  int rec_id, uint8_t* addr_out) {
  return ecrecover(hash, r, s, rec_id, addr_out);
}

}  // extern "C"
