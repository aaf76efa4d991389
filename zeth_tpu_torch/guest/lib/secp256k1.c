/* secp256k1 public-key recovery over the bigint accelerator.
 *
 * The in-guest role of risc0's k256 patch (SURVEY.md §2.1 guest crypto
 * patches: k256 backed by risc0-bigint2,
 * guests/stateless-client/Cargo.lock:4034-4041): every field/scalar
 * multiplication is one SYS_BIGINT modmul (operands kept < m so the
 * circuit's 256-bit quotient bound holds). Jacobian coordinates with a
 * Shamir double-scalar ladder for u1*G + u2*R.
 */
#include <stdint.h>
#include <string.h>
#include <zeth.h>
#include <u256.h>
#include <keccak.h>
#include <secp256k1.h>

/* p = 2^256 - 2^32 - 977, n = group order, G = generator */
static const uint32_t P_W[8] = {
  0xFFFFFC2F, 0xFFFFFFFE, 0xFFFFFFFF, 0xFFFFFFFF,
  0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF};
static const uint32_t N_W[8] = {
  0xD0364141, 0xBFD25E8C, 0xAF48A03B, 0xBAAEDCE6,
  0xFFFFFFFE, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF};
static const uint32_t GX_W[8] = {
  0x16F81798, 0x59F2815B, 0x2DCE28D9, 0x029BFCDB,
  0xCE870B07, 0x55A06295, 0xF9DCBBAC, 0x79BE667E};
static const uint32_t GY_W[8] = {
  0xFB10D4B8, 0x9C47D08F, 0xA6855419, 0xFD17B448,
  0x0E1108A8, 0x5DA4FBFC, 0x26A3C465, 0x483ADA77};

static u256 SP, SN, SGX, SGY;
static uint32_t secp_ready = 0;

static void secp_init(void) {
  if (secp_ready) return;
  memcpy(SP.w, P_W, 32);
  memcpy(SN.w, N_W, 32);
  memcpy(SGX.w, GX_W, 32);
  memcpy(SGY.w, GY_W, 32);
  secp_ready = 1;
}

/* field ops mod p (operands < p) */
static void fmul(u256 *r, const u256 *a, const u256 *b) {
  u256_modmul_raw(r, a, b, &SP);
}

static void fadd(u256 *r, const u256 *a, const u256 *b) {
  uint32_t c = u256_add(r, a, b);
  if (c || u256_cmp(r, &SP) >= 0) u256_sub(r, r, &SP);
}

static void fsub(u256 *r, const u256 *a, const u256 *b) {
  if (u256_cmp(a, b) >= 0) {
    u256_sub(r, a, b);
  } else {
    u256 t;
    u256_sub(&t, b, a);
    u256_sub(r, &SP, &t);
  }
}

static void fpow(u256 *r, const u256 *a, const u256 *e, const u256 *m) {
  u256 acc, base;
  int i;
  uint32_t bl = u256_bitlen(e);
  u256_from_u32(&acc, 1);
  base = *a;
  for (i = 0; i < (int)bl; i++) {
    if (u256_bit(e, (uint32_t)i)) u256_modmul_raw(&acc, &acc, &base, m);
    if (i + 1 < (int)bl) u256_modmul_raw(&base, &base, &base, m);
  }
  *r = acc;
}

/* Jacobian point (X, Y, Z); Z = 0 -> infinity */
typedef struct { u256 x, y, z; } jpt;

static void jdouble(jpt *r, const jpt *a) {
  /* r may alias a: compute into o, copy out at the end */
  jpt o;
  u256 A, B, C, D, E, F, t;
  if (u256_is_zero(&a->z) || u256_is_zero(&a->y)) {
    u256_zero(&r->x); u256_zero(&r->y); u256_zero(&r->z);
    u256_from_u32(&r->x, 1); u256_from_u32(&r->y, 1);
    return;
  }
  fmul(&A, &a->x, &a->x);            /* A = X^2 */
  fmul(&B, &a->y, &a->y);            /* B = Y^2 */
  fmul(&C, &B, &B);                  /* C = B^2 */
  fadd(&t, &a->x, &B);
  fmul(&t, &t, &t);                  /* (X+B)^2 */
  fsub(&t, &t, &A);
  fsub(&t, &t, &C);
  fadd(&D, &t, &t);                  /* D = 2((X+B)^2 - A - C) */
  fadd(&E, &A, &A);
  fadd(&E, &E, &A);                  /* E = 3A */
  fmul(&F, &E, &E);                  /* F = E^2 */
  fsub(&F, &F, &D);
  fsub(&o.x, &F, &D);               /* X3 = F - 2D */
  fsub(&t, &D, &o.x);
  fmul(&t, &E, &t);
  {
    u256 c8;
    fadd(&c8, &C, &C);
    fadd(&c8, &c8, &c8);
    fadd(&c8, &c8, &c8);             /* 8C */
    fsub(&o.y, &t, &c8);
  }
  fmul(&t, &a->y, &a->z);
  fadd(&o.z, &t, &t);               /* Z3 = 2YZ */
  *r = o;
}

static void jadd(jpt *r, const jpt *a, const jpt *b) {
  /* r may alias a or b: compute into o, copy out at the end */
  jpt o;
  u256 Z1Z1, Z2Z2, U1, U2, S1, S2, H, I, J, rr, V, t;
  if (u256_is_zero(&a->z)) { *r = *b; return; }
  if (u256_is_zero(&b->z)) { *r = *a; return; }
  fmul(&Z1Z1, &a->z, &a->z);
  fmul(&Z2Z2, &b->z, &b->z);
  fmul(&U1, &a->x, &Z2Z2);
  fmul(&U2, &b->x, &Z1Z1);
  fmul(&S1, &a->y, &b->z);
  fmul(&S1, &S1, &Z2Z2);
  fmul(&S2, &b->y, &a->z);
  fmul(&S2, &S2, &Z1Z1);
  if (u256_eq(&U1, &U2)) {
    if (u256_eq(&S1, &S2)) { jdouble(r, a); return; }
    u256_zero(&r->z);
    u256_from_u32(&r->x, 1); u256_from_u32(&r->y, 1);
    return;
  }
  fsub(&H, &U2, &U1);
  fadd(&I, &H, &H);
  fmul(&I, &I, &I);                  /* I = (2H)^2 */
  fmul(&J, &H, &I);
  fsub(&rr, &S2, &S1);
  fadd(&rr, &rr, &rr);               /* r = 2(S2-S1) */
  fmul(&V, &U1, &I);
  fmul(&t, &rr, &rr);
  fsub(&t, &t, &J);
  fsub(&t, &t, &V);
  fsub(&o.x, &t, &V);               /* X3 = r^2 - J - 2V */
  fsub(&t, &V, &o.x);
  fmul(&t, &rr, &t);
  {
    u256 s1j;
    fmul(&s1j, &S1, &J);
    fadd(&s1j, &s1j, &s1j);
    fsub(&o.y, &t, &s1j);           /* Y3 = r(V-X3) - 2 S1 J */
  }
  fadd(&t, &a->z, &b->z);
  fmul(&t, &t, &t);
  fsub(&t, &t, &Z1Z1);
  fsub(&t, &t, &Z2Z2);
  fmul(&o.z, &t, &H);               /* Z3 = ((Z1+Z2)^2-Z1Z1-Z2Z2) H */
  *r = o;
}

uint32_t secp_ecrecover(const uint8_t hash[32], uint32_t recid,
                        const u256 *r, const u256 *s, uint8_t out_addr[20]) {
  u256 e, rinv, u1, u2, x, y, y2, t, exp;
  jpt R, G, GR, acc;
  uint32_t i;
  secp_init();
  if (recid > 1) return 0;
  if (u256_is_zero(r) || u256_is_zero(s)) return 0;
  if (u256_cmp(r, &SN) >= 0 || u256_cmp(s, &SN) >= 0) return 0;

  /* R point: x = r (the x >= n overflow case needs r + n < p; ~2^-128
   * probability — treated as invalid, matching common practice) */
  x = *r;
  if (u256_cmp(&x, &SP) >= 0) return 0;
  /* y^2 = x^3 + 7 */
  fmul(&y2, &x, &x);
  fmul(&y2, &y2, &x);
  u256_from_u32(&t, 7);
  fadd(&y2, &y2, &t);
  /* y = y2^((p+1)/4) */
  u256_from_u32(&t, 1);
  u256_add(&exp, &SP, &t);
  u256_shr(&exp, &exp, 2);
  fpow(&y, &y2, &exp, &SP);
  /* verify y^2 == y2 (else x^3+7 is a non-residue -> invalid) */
  fmul(&t, &y, &y);
  if (!u256_eq(&t, &y2)) return 0;
  if ((y.w[0] & 1) != (recid & 1)) fsub(&y, &SP, &y);

  /* scalars: e = hash mod n; u1 = -e/r; u2 = s/r (mod n) */
  u256_from_be(&e, hash);
  u256_redc(&e, &e, &SN);
  u256_from_u32(&t, 2);
  u256_sub(&exp, &SN, &t);           /* n - 2 */
  fpow(&rinv, r, &exp, &SN);
  if (!u256_is_zero(&e)) {
    u256_sub(&t, &SN, &e);           /* -e mod n */
  } else {
    u256_zero(&t);
  }
  u256_modmul_raw(&u1, &t, &rinv, &SN);
  u256_modmul_raw(&u2, s, &rinv, &SN);

  /* Q = u1*G + u2*R via a Shamir ladder */
  R.x = x; R.y = y; u256_from_u32(&R.z, 1);
  G.x = SGX; G.y = SGY; u256_from_u32(&G.z, 1);
  jadd(&GR, &G, &R);
  u256_zero(&acc.x); u256_zero(&acc.y); u256_zero(&acc.z);
  u256_from_u32(&acc.x, 1); u256_from_u32(&acc.y, 1);
  {
    uint32_t b1 = u256_bitlen(&u1), b2 = u256_bitlen(&u2);
    uint32_t bl = b1 > b2 ? b1 : b2;
    for (i = bl; i > 0; i--) {
      uint32_t k1, k2;
      jdouble(&acc, &acc);
      k1 = u256_bit(&u1, i - 1);
      k2 = u256_bit(&u2, i - 1);
      if (k1 && k2) jadd(&acc, &acc, &GR);
      else if (k1) jadd(&acc, &acc, &G);
      else if (k2) jadd(&acc, &acc, &R);
    }
  }
  if (u256_is_zero(&acc.z)) return 0;

  /* affine: x = X/Z^2, y = Y/Z^3 */
  u256_from_u32(&t, 2);
  u256_sub(&exp, &SP, &t);
  fpow(&t, &acc.z, &exp, &SP);       /* 1/Z */
  {
    u256 zi2, zi3, ax, ay;
    fmul(&zi2, &t, &t);
    fmul(&zi3, &zi2, &t);
    fmul(&ax, &acc.x, &zi2);
    fmul(&ay, &acc.y, &zi3);
    {
      uint8_t xy[64];
      uint8_t d[32];
      u256_to_be(&ax, xy);
      u256_to_be(&ay, xy + 32);
      keccak256(xy, 64, d);
      memcpy(out_addr, d + 12, 20);
    }
  }
  return 1;
}
