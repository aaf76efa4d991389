/* Guest hashes: sha-256 (via the SYS_SHA256 accelerator), ripemd-160
 * and blake2f in pure 32-bit C (precompiles 0x02/0x03/0x09; reference
 * role: the patched sha2 crate + revm precompiles, SURVEY.md §2.1). */
#include <stdint.h>
#include <string.h>
#include <zeth.h>
#include <hashes.h>

/* io = [state(8w) | block(16w) | out(8w)] for the syscall */
static uint32_t sha_io[32];

static void sha_block(const uint8_t *blk) {
  uint32_t i;
  for (i = 0; i < 16; i++)
    sha_io[8 + i] = ((uint32_t)blk[4 * i] << 24)
                    | ((uint32_t)blk[4 * i + 1] << 16)
                    | ((uint32_t)blk[4 * i + 2] << 8) | blk[4 * i + 3];
  sys_sha256_compress(sha_io);
  for (i = 0; i < 8; i++) sha_io[i] = sha_io[24 + i];
}

void sha256(const uint8_t *data, uint32_t len, uint8_t out[32]) {
  uint8_t last[128];
  uint32_t i, rem, total;
  sha_io[0] = 0x6a09e667u; sha_io[1] = 0xbb67ae85u;
  sha_io[2] = 0x3c6ef372u; sha_io[3] = 0xa54ff53au;
  sha_io[4] = 0x510e527fu; sha_io[5] = 0x9b05688cu;
  sha_io[6] = 0x1f83d9abu; sha_io[7] = 0x5be0cd19u;
  total = len;
  while (len >= 64) {
    sha_block(data);
    data += 64;
    len -= 64;
  }
  memset(last, 0, 128);
  memcpy(last, data, len);
  last[len] = 0x80;
  rem = len < 56 ? 64 : 128;
  /* 64-bit bit length: total < 2^32 bytes -> bits fit 35 bits */
  {
    uint32_t hi = total >> 29;
    uint32_t lo = total << 3;
    last[rem - 8] = 0;
    last[rem - 7] = 0;
    last[rem - 6] = 0;
    last[rem - 5] = (uint8_t)hi;
    last[rem - 4] = (uint8_t)(lo >> 24);
    last[rem - 3] = (uint8_t)(lo >> 16);
    last[rem - 2] = (uint8_t)(lo >> 8);
    last[rem - 1] = (uint8_t)lo;
  }
  sha_block(last);
  if (rem == 128) sha_block(last + 64);
  for (i = 0; i < 8; i++) {
    out[4 * i] = (uint8_t)(sha_io[i] >> 24);
    out[4 * i + 1] = (uint8_t)(sha_io[i] >> 16);
    out[4 * i + 2] = (uint8_t)(sha_io[i] >> 8);
    out[4 * i + 3] = (uint8_t)sha_io[i];
  }
}

/* -- ripemd-160 ----------------------------------------------------------- */

static const uint8_t R1T[80] = {
  0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,
  7,4,13,1,10,6,15,3,12,0,9,5,2,14,11,8,
  3,10,14,4,9,15,8,1,2,7,0,6,13,11,5,12,
  1,9,11,10,0,8,12,4,13,3,7,15,14,5,6,2,
  4,0,5,9,7,12,2,10,14,1,3,8,11,6,15,13};
static const uint8_t R2T[80] = {
  5,14,7,0,9,2,11,4,13,6,15,8,1,10,3,12,
  6,11,3,7,0,13,5,10,14,15,8,12,4,9,1,2,
  15,5,1,3,7,14,6,9,11,8,12,2,10,0,4,13,
  8,6,4,1,3,11,15,0,5,12,2,13,9,7,10,14,
  12,15,10,4,1,5,8,7,6,2,13,14,0,3,9,11};
static const uint8_t S1T[80] = {
  11,14,15,12,5,8,7,9,11,13,14,15,6,7,9,8,
  7,6,8,13,11,9,7,15,7,12,15,9,11,7,13,12,
  11,13,6,7,14,9,13,15,14,8,13,6,5,12,7,5,
  11,12,14,15,14,15,9,8,9,14,5,6,8,6,5,12,
  9,15,5,11,6,8,13,12,5,12,13,14,11,8,5,6};
static const uint8_t S2T[80] = {
  8,9,9,11,13,15,15,5,7,7,8,11,14,14,12,6,
  9,13,15,7,12,8,9,11,7,7,12,7,6,15,13,11,
  9,7,15,11,8,6,6,14,12,13,5,14,13,13,7,5,
  15,5,8,11,14,14,6,14,6,9,12,9,12,5,15,8,
  8,5,12,9,12,5,14,6,8,13,6,5,15,13,11,11};

static uint32_t rol(uint32_t x, uint32_t n) {
  return (x << n) | (x >> (32 - n));
}

static uint32_t rf(uint32_t j, uint32_t x, uint32_t y, uint32_t z) {
  if (j < 16) return x ^ y ^ z;
  if (j < 32) return (x & y) | (~x & z);
  if (j < 48) return (x | ~y) ^ z;
  if (j < 64) return (x & z) | (y & ~z);
  return x ^ (y | ~z);
}

static void rmd_block(uint32_t h[5], const uint8_t *blk) {
  static const uint32_t K1[5] = {0, 0x5a827999u, 0x6ed9eba1u,
                                 0x8f1bbcdcu, 0xa953fd4eu};
  static const uint32_t K2[5] = {0x50a28be6u, 0x5c4dd124u, 0x6d703ef3u,
                                 0x7a6d76e9u, 0};
  uint32_t x[16];
  uint32_t a, b, c, d, e, a2, b2, c2, d2, e2, j, t;
  for (j = 0; j < 16; j++)
    x[j] = (uint32_t)blk[4 * j] | ((uint32_t)blk[4 * j + 1] << 8)
           | ((uint32_t)blk[4 * j + 2] << 16)
           | ((uint32_t)blk[4 * j + 3] << 24);
  a = h[0]; b = h[1]; c = h[2]; d = h[3]; e = h[4];
  a2 = h[0]; b2 = h[1]; c2 = h[2]; d2 = h[3]; e2 = h[4];
  for (j = 0; j < 80; j++) {
    t = rol(a + rf(j, b, c, d) + x[R1T[j]] + K1[j / 16], S1T[j]) + e;
    a = e; e = d; d = rol(c, 10); c = b; b = t;
    t = rol(a2 + rf(79 - j, b2, c2, d2) + x[R2T[j]] + K2[j / 16],
            S2T[j]) + e2;
    a2 = e2; e2 = d2; d2 = rol(c2, 10); c2 = b2; b2 = t;
  }
  t = h[1] + c + d2;
  h[1] = h[2] + d + e2;
  h[2] = h[3] + e + a2;
  h[3] = h[4] + a + b2;
  h[4] = h[0] + b + c2;
  h[0] = t;
}

void ripemd160(const uint8_t *data, uint32_t len, uint8_t out[20]) {
  uint32_t h[5];
  uint8_t last[128];
  uint32_t rem, total, i;
  h[0] = 0x67452301u; h[1] = 0xefcdab89u; h[2] = 0x98badcfeu;
  h[3] = 0x10325476u; h[4] = 0xc3d2e1f0u;
  total = len;
  while (len >= 64) {
    rmd_block(h, data);
    data += 64;
    len -= 64;
  }
  memset(last, 0, 128);
  memcpy(last, data, len);
  last[len] = 0x80;
  rem = len < 56 ? 64 : 128;
  {
    uint32_t lo = total << 3, hi = total >> 29;
    last[rem - 8] = (uint8_t)lo;
    last[rem - 7] = (uint8_t)(lo >> 8);
    last[rem - 6] = (uint8_t)(lo >> 16);
    last[rem - 5] = (uint8_t)(lo >> 24);
    last[rem - 4] = (uint8_t)hi;
  }
  rmd_block(h, last);
  if (rem == 128) rmd_block(h, last + 64);
  for (i = 0; i < 5; i++) {
    out[4 * i] = (uint8_t)h[i];
    out[4 * i + 1] = (uint8_t)(h[i] >> 8);
    out[4 * i + 2] = (uint8_t)(h[i] >> 16);
    out[4 * i + 3] = (uint8_t)(h[i] >> 24);
  }
}

/* -- blake2f: 64-bit lanes as lo/hi u32 pairs ------------------------------ */

typedef struct { uint32_t lo, hi; } w64;

static void w64_add(w64 *r, const w64 *a, const w64 *b) {
  uint32_t lo = a->lo + b->lo;
  r->hi = a->hi + b->hi + (lo < a->lo);
  r->lo = lo;
}

static void w64_xor(w64 *r, const w64 *a, const w64 *b) {
  r->lo = a->lo ^ b->lo;
  r->hi = a->hi ^ b->hi;
}

static void w64_ror(w64 *r, const w64 *a, uint32_t n) {
  uint32_t lo = a->lo, hi = a->hi;
  if (n == 32) { r->lo = hi; r->hi = lo; return; }
  if (n < 32) {
    r->lo = (lo >> n) | (hi << (32 - n));
    r->hi = (hi >> n) | (lo << (32 - n));
    return;
  }
  n -= 32;
  r->lo = (hi >> n) | (lo << (32 - n));
  r->hi = (lo >> n) | (hi << (32 - n));
}

static const uint8_t BSIG[10][16] = {
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

static const uint32_t BIV[16] = {
  0xf3bcc908u, 0x6a09e667u, 0x84caa73bu, 0xbb67ae85u,
  0xfe94f82bu, 0x3c6ef372u, 0x5f1d36f1u, 0xa54ff53au,
  0xade682d1u, 0x510e527fu, 0x2b3e6c1fu, 0x9b05688cu,
  0xfb41bd6bu, 0x1f83d9abu, 0x137e2179u, 0x5be0cd19u};

static w64 bv[16];
static w64 bm[16];

static void bG(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
               const w64 *x, const w64 *y) {
  w64 t;
  w64_add(&t, &bv[a], &bv[b]);
  w64_add(&bv[a], &t, x);
  w64_xor(&t, &bv[d], &bv[a]);
  w64_ror(&bv[d], &t, 32);
  w64_add(&bv[c], &bv[c], &bv[d]);
  w64_xor(&t, &bv[b], &bv[c]);
  w64_ror(&bv[b], &t, 24);
  w64_add(&t, &bv[a], &bv[b]);
  w64_add(&bv[a], &t, y);
  w64_xor(&t, &bv[d], &bv[a]);
  w64_ror(&bv[d], &t, 16);
  w64_add(&bv[c], &bv[c], &bv[d]);
  w64_xor(&t, &bv[b], &bv[c]);
  w64_ror(&bv[b], &t, 63);
}

static uint32_t le32(const uint8_t *p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16)
         | ((uint32_t)p[3] << 24);
}

void blake2f(uint32_t rounds, uint8_t h[64], const uint8_t m[128],
             const uint8_t t[16], uint32_t final_flag) {
  w64 hh[8];
  uint32_t i, r;
  for (i = 0; i < 8; i++) {
    hh[i].lo = le32(h + 8 * i);
    hh[i].hi = le32(h + 8 * i + 4);
  }
  for (i = 0; i < 16; i++) {
    bm[i].lo = le32(m + 8 * i);
    bm[i].hi = le32(m + 8 * i + 4);
  }
  for (i = 0; i < 8; i++) bv[i] = hh[i];
  for (i = 0; i < 8; i++) {
    bv[8 + i].lo = BIV[2 * i];
    bv[8 + i].hi = BIV[2 * i + 1];
  }
  bv[12].lo ^= le32(t);
  bv[12].hi ^= le32(t + 4);
  bv[13].lo ^= le32(t + 8);
  bv[13].hi ^= le32(t + 12);
  if (final_flag) {
    bv[14].lo = ~bv[14].lo;
    bv[14].hi = ~bv[14].hi;
  }
  for (r = 0; r < rounds; r++) {
    const uint8_t *s = BSIG[r % 10];
    bG(0, 4, 8, 12, &bm[s[0]], &bm[s[1]]);
    bG(1, 5, 9, 13, &bm[s[2]], &bm[s[3]]);
    bG(2, 6, 10, 14, &bm[s[4]], &bm[s[5]]);
    bG(3, 7, 11, 15, &bm[s[6]], &bm[s[7]]);
    bG(0, 5, 10, 15, &bm[s[8]], &bm[s[9]]);
    bG(1, 6, 11, 12, &bm[s[10]], &bm[s[11]]);
    bG(2, 7, 8, 13, &bm[s[12]], &bm[s[13]]);
    bG(3, 4, 9, 14, &bm[s[14]], &bm[s[15]]);
  }
  for (i = 0; i < 8; i++) {
    w64 o, t;
    w64_xor(&t, &bv[i], &bv[8 + i]);
    w64_xor(&o, &hh[i], &t);
    h[8 * i] = (uint8_t)o.lo;
    h[8 * i + 1] = (uint8_t)(o.lo >> 8);
    h[8 * i + 2] = (uint8_t)(o.lo >> 16);
    h[8 * i + 3] = (uint8_t)(o.lo >> 24);
    h[8 * i + 4] = (uint8_t)o.hi;
    h[8 * i + 5] = (uint8_t)(o.hi >> 8);
    h[8 * i + 6] = (uint8_t)(o.hi >> 16);
    h[8 * i + 7] = (uint8_t)(o.hi >> 24);
  }
}
