/* 256-bit arithmetic on 32-bit limbs for the EVM guest.
 *
 * The in-guest role of the reference's crypto-bigint/ruint stack
 * (SURVEY.md §2.2 reth/revm u256 math). MULMOD/ADDMOD and all modular
 * work route through the SYS_BIGINT accelerator (risc0-bigint2's role):
 * the circuit proves a*b = q*m + r with a 256-bit q, so operands are
 * reduced below m first (q then stays < 2^256).
 */
#include <stdint.h>
#include <string.h>
#include <zeth.h>
#include <u256.h>

void u256_zero(u256 *r) { memset(r->w, 0, 32); }

void u256_from_u32(u256 *r, uint32_t v) {
  memset(r->w, 0, 32);
  r->w[0] = v;
}

uint32_t u256_is_zero(const u256 *a) {
  uint32_t acc = 0, i;
  for (i = 0; i < 8; i++) acc |= a->w[i];
  return acc == 0;
}

int u256_cmp(const u256 *a, const u256 *b) {
  if (__u256_lt(a->w, b->w)) return -1;
  if (__u256_lt(b->w, a->w)) return 1;
  return 0;
}

uint32_t u256_eq(const u256 *a, const u256 *b) {
  uint32_t acc = 0, i;
  for (i = 0; i < 8; i++) acc |= a->w[i] ^ b->w[i];
  return acc == 0;
}

uint32_t u256_add(u256 *r, const u256 *a, const u256 *b) {
  return __u256_add(r->w, a->w, b->w);
}

uint32_t u256_sub(u256 *r, const u256 *a, const u256 *b) {
  return __u256_sub(r->w, a->w, b->w);
}

void u256_mul(u256 *r, const u256 *a, const u256 *b) {
  uint32_t t[8];
  uint32_t i, j;
  memset(t, 0, 32);
  for (i = 0; i < 8; i++) {
    uint32_t carry = 0;
    uint32_t ai = a->w[i];
    if (ai == 0) continue;
    for (j = 0; i + j < 8; j++) {
      uint32_t lo = ai * b->w[j];
      uint32_t hi = __mulhu(ai, b->w[j]);
      uint32_t s = t[i + j] + lo;
      hi += s < lo;
      uint32_t s2 = s + carry;
      hi += s2 < s;
      t[i + j] = s2;
      carry = hi;
    }
  }
  memcpy(r->w, t, 32);
}

uint32_t u256_bitlen(const u256 *a) {
  int i;
  for (i = 7; i >= 0; i--) {
    uint32_t v = a->w[i];
    if (v) {
      uint32_t n = 0;
      if (v >> 16) { n += 16; v >>= 16; }
      if (v >> 8) { n += 8; v >>= 8; }
      if (v >> 4) { n += 4; v >>= 4; }
      if (v >> 2) { n += 2; v >>= 2; }
      if (v >> 1) { n += 1; }
      return (uint32_t)i * 32 + n + 1;
    }
  }
  return 0;
}

uint32_t u256_bit(const u256 *a, uint32_t i) {
  return (a->w[i >> 5] >> (i & 31)) & 1;
}

void u256_shl(u256 *r, const u256 *a, uint32_t sh) {
  u256 t;
  int i;
  if (sh >= 256) { u256_zero(r); return; }
  {
    uint32_t limb = sh >> 5, off = sh & 31;
    for (i = 7; i >= 0; i--) {
      uint32_t v = 0;
      if ((uint32_t)i >= limb) {
        v = a->w[i - limb] << off;
        if (off && i - (int)limb - 1 >= 0)
          v |= a->w[i - limb - 1] >> (32 - off);
      }
      t.w[i] = v;
    }
  }
  *r = t;
}

void u256_shr(u256 *r, const u256 *a, uint32_t sh) {
  u256 t;
  uint32_t i;
  if (sh >= 256) { u256_zero(r); return; }
  {
    uint32_t limb = sh >> 5, off = sh & 31;
    for (i = 0; i < 8; i++) {
      uint32_t v = 0;
      if (i + limb < 8) {
        v = a->w[i + limb] >> off;
        if (off && i + limb + 1 < 8) v |= a->w[i + limb + 1] << (32 - off);
      }
      t.w[i] = v;
    }
  }
  *r = t;
}

void u256_sar(u256 *r, const u256 *a, uint32_t sh) {
  uint32_t neg = a->w[7] >> 31;
  if (sh >= 256) {
    if (neg) memset(r->w, 0xFF, 32); else u256_zero(r);
    return;
  }
  u256_shr(r, a, sh);
  if (neg && sh) {
    u256 mask, one;
    u256_from_u32(&one, 1);
    /* mask = ~0 << (256 - sh) */
    memset(mask.w, 0xFF, 32);
    u256_shl(&mask, &mask, 256 - sh);
    {
      uint32_t i;
      for (i = 0; i < 8; i++) r->w[i] |= mask.w[i];
    }
    (void)one;
  }
}

void u256_not(u256 *r, const u256 *a) {
  uint32_t i;
  for (i = 0; i < 8; i++) r->w[i] = ~a->w[i];
}

void u256_neg(u256 *r, const u256 *a) {
  u256 z;
  u256_zero(&z);
  u256_sub(r, &z, a);
}

int u256_scmp(const u256 *a, const u256 *b) {
  uint32_t sa = a->w[7] >> 31, sb = b->w[7] >> 31;
  if (sa != sb) return sa ? -1 : 1;
  return u256_cmp(a, b);
}

/* q = a / b, rem -> *r (binary long division, top-bit aligned) */
static void divmod_full(u256 *q, u256 *r, const u256 *a, const u256 *b) {
  u256 rem, quo;
  int bl, i;
  u256_zero(&rem);
  u256_zero(&quo);
  if (u256_is_zero(b) || u256_cmp(a, b) < 0) {
    if (q) *q = quo;
    if (r) { if (u256_is_zero(b)) u256_zero(&rem); else rem = *a; *r = rem; }
    return;
  }
  /* fast path: divisor fits one limb and dividend fits two limbs often
   * happens for gas math done in u256; handle the one-limb divisor with
   * 16-bit half-limb short division (32/32 divu only) */
  if (u256_bitlen(b) <= 16) {
    uint32_t d = b->w[0];
    uint32_t carry = 0;
    int k;
    for (k = 15; k >= 0; k--) {
      uint32_t limb16 = (a->w[k >> 1] >> ((k & 1) ? 16 : 0)) & 0xFFFF;
      uint32_t cur = (carry << 16) | limb16;
      uint32_t qd = cur / d;
      carry = cur - qd * d;
      quo.w[k >> 1] |= qd << ((k & 1) ? 16 : 0);
    }
    if (q) *q = quo;
    if (r) u256_from_u32(r, carry);
    return;
  }
  bl = (int)u256_bitlen(a);
  for (i = bl - 1; i >= 0; i--) {
    u256_shl(&rem, &rem, 1);
    rem.w[0] |= u256_bit(a, (uint32_t)i);
    if (u256_cmp(&rem, b) >= 0) {
      u256_sub(&rem, &rem, b);
      quo.w[i >> 5] |= 1u << (i & 31);
    }
  }
  if (q) *q = quo;
  if (r) *r = rem;
}

void u256_div(u256 *q, const u256 *a, const u256 *b) {
  divmod_full(q, 0, a, b);
}

void u256_mod(u256 *r, const u256 *a, const u256 *b) {
  divmod_full(0, r, a, b);
}

void u256_sdiv(u256 *q, const u256 *a, const u256 *b) {
  u256 aa = *a, bb = *b, t;
  uint32_t sa = a->w[7] >> 31, sb = b->w[7] >> 31;
  if (sa) u256_neg(&aa, a);
  if (sb) u256_neg(&bb, b);
  u256_div(&t, &aa, &bb);
  if (sa != sb) u256_neg(q, &t); else *q = t;
}

void u256_smod(u256 *r, const u256 *a, const u256 *b) {
  u256 aa = *a, bb = *b, t;
  uint32_t sa = a->w[7] >> 31, sb = b->w[7] >> 31;
  if (sa) u256_neg(&aa, a);
  if (sb) u256_neg(&bb, b);
  u256_mod(&t, &aa, &bb);
  if (sa) u256_neg(r, &t); else *r = t;
}

/* bigint accelerator IO block (static: gmalloc-free hot path).
 * The accelerator is 384-bit wide (4 x 12-word slots); 256-bit
 * operands occupy the low 8 words of each slot, highs stay zero. */
static uint32_t big_io[48];

static void bigint_raw(u256 *r, const u256 *a, const u256 *b, const u256 *m) {
  memcpy(big_io, a->w, 32);
  memcpy(big_io + 12, b->w, 32);
  memcpy(big_io + 24, m->w, 32);
  sys_bigint_modmul(big_io);
  memcpy(r->w, big_io + 36, 32);
}

void u256_modmul_raw(u256 *r, const u256 *a, const u256 *b, const u256 *m) {
  bigint_raw(r, a, b, m);
}

void u256_redc(u256 *r, const u256 *a, const u256 *m) {
  u256 one;
  u256_from_u32(&one, 1);
  bigint_raw(r, a, &one, m);
}

void u256_modmul(u256 *r, const u256 *a, const u256 *b, const u256 *m) {
  u256 ra, rb;
  u256_redc(&ra, a, m);
  u256_redc(&rb, b, m);
  bigint_raw(r, &ra, &rb, m);
}

void u256_mulmod(u256 *r, const u256 *a, const u256 *b, const u256 *m) {
  if (u256_is_zero(m)) { u256_zero(r); return; }
  u256_modmul(r, a, b, m);
}

void u256_addmod(u256 *r, const u256 *a, const u256 *b, const u256 *m) {
  u256 ra, rb, s;
  uint32_t c;
  if (u256_is_zero(m)) { u256_zero(r); return; }
  u256_redc(&ra, a, m);
  u256_redc(&rb, b, m);
  c = u256_add(&s, &ra, &rb);
  if (c || u256_cmp(&s, m) >= 0) u256_sub(&s, &s, m);
  *r = s;
}

void u256_exp(u256 *r, const u256 *a, const u256 *e) {
  u256 acc, base;
  uint32_t bl, i;
  u256_from_u32(&acc, 1);
  base = *a;
  bl = u256_bitlen(e);
  for (i = 0; i < bl; i++) {
    if (u256_bit(e, i)) u256_mul(&acc, &acc, &base);
    if (i + 1 < bl) u256_mul(&base, &base, &base);
  }
  *r = acc;
}

void u256_from_be(u256 *r, const uint8_t be[32]) {
  uint32_t i;
  for (i = 0; i < 8; i++) {
    const uint8_t *p = be + (7 - i) * 4;
    r->w[i] = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16)
              | ((uint32_t)p[2] << 8) | p[3];
  }
}

void u256_to_be(const u256 *a, uint8_t be[32]) {
  uint32_t i;
  for (i = 0; i < 8; i++) {
    uint8_t *p = be + (7 - i) * 4;
    uint32_t v = a->w[i];
    p[0] = (uint8_t)(v >> 24);
    p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8);
    p[3] = (uint8_t)v;
  }
}

void u256_from_be_n(u256 *r, const uint8_t *be, uint32_t n) {
  uint8_t buf[32];
  memset(buf, 0, 32);
  if (n > 32) { be += n - 32; n = 32; }
  memcpy(buf + 32 - n, be, n);
  u256_from_be(r, buf);
}

uint32_t u256_to_be_min(const u256 *a, uint8_t out[32]) {
  uint8_t full[32];
  uint32_t i = 0;
  u256_to_be(a, full);
  while (i < 32 && full[i] == 0) i++;
  memcpy(out, full + i, 32 - i);
  return 32 - i;
}

uint32_t u256_fits_u32(const u256 *a) {
  uint32_t acc = 0, i;
  for (i = 1; i < 8; i++) acc |= a->w[i];
  return acc == 0;
}

uint32_t u256_low_u32(const u256 *a) { return a->w[0]; }
