/* alt_bn128 (BN254) optimal ate pairing over the SYS_BIGINT accelerator.
 *
 * Guest-side mirror of the host engine's zeth_tpu/app/bn254.py (which
 * backs the same precompile on the host validation path): the tower
 * Fp2 = Fp[u]/(u^2+1), Fp6 = Fp2[v]/(v^3 - (9+u)), Fp12 = Fp6[w]/(w^2-v),
 * affine Miller loop with the two Frobenius correction lines, and the
 * final exponentiation's hard part by plain square-and-multiply with the
 * 761-bit exponent (p^4 - p^2 + 1)/r. The reference guest gets this from
 * substrate-bn patched onto risc0-bigint2 (SURVEY.md §2.2 guest crypto
 * patches); here every Fp mulmod is one accelerator syscall.
 */
#include <stdint.h>
#include <string.h>
#include "u256.h"
#include "bn254.h"

/* field modulus p (little-endian u32 limbs) */
static const uint32_t BN_P_W[8] = {
  0xD87CFD47, 0x3C208C16, 0x6871CA8D, 0x97816A91,
  0x8181585D, 0xB85045B6, 0xE131A029, 0x30644E72};
/* group order r */
static const uint32_t BN_R_W[8] = {
  0xF0000001, 0x43E1F593, 0x79B97091, 0x2833E848,
  0x8181585D, 0xB85045B6, 0xE131A029, 0x30644E72};

/* Frobenius gammas: G1F[i] = (9+u)^(i*(p-1)/6) in Fp2, i = 1..5
 * (derived in zeth_tpu/app/bn254.py; re/im little-endian limbs) */
static const uint32_t G1F_RE[5][8] = {
  {0xDCC9E470, 0xD60B35DA, 0x292F2176, 0x5C521E08,
   0x76E68B60, 0xE8B99FDD, 0x2865A7DF, 0x1284B71C},
  {0x176F553D, 0x99E39557, 0xC2C3330C, 0xB78CC310,
   0xF559B143, 0x4C0BEC3C, 0x4F7911F7, 0x2FB34798},
  {0x71A0135A, 0xDC540146, 0xA9C95998, 0xDBAAE0ED,
   0xB6E2F9B9, 0xDC5EC698, 0x489AF5DC, 0x063CF305},
  {0x921EA762, 0x848A1F55, 0xBE94EC72, 0xD33365F7,
   0x5A181E84, 0x80F3C0B7, 0x64EEA801, 0x05B54F5E},
  {0xEAB7692F, 0x2EA2C810, 0x55AA1BD3, 0x425C459B,
   0xA4353FF4, 0xE93A3661, 0x4F798649, 0x0183C1E7}};
static const uint32_t G1F_IM[5][8] = {
  {0x80F362AC, 0xCA5CF05F, 0x8EEEC7E5, 0x74799277,
   0x12150B8E, 0xA6327CFE, 0xB4FAE7E6, 0x246996F3},
  {0x640FCBA2, 0x1665D51C, 0x0B7C9DCE, 0x32AE2A1D,
   0xD75A0794, 0x4BA4CC8B, 0x61EBAE20, 0x16C9E550},
  {0x2623B0E3, 0x82D37F63, 0x8FA25BD2, 0x21807DC9,
   0xEC796F2B, 0x0704B5A7, 0xAC41049A, 0x07C03CBC},
  {0xCD2B8126, 0xC13B4711, 0x1BDEC763, 0x3685D2EA,
   0x3B0B1C92, 0x9F3A80B0, 0xE7FD8AEE, 0x2C145EDB},
  {0x6E0C2C4B, 0x24C6B8EE, 0x678E2AC0, 0xB080CB99,
   0xC7729F7D, 0xA27FB246, 0x76FD0675, 0x12ACF2CA}};

/* hard-part exponent (p^4 - p^2 + 1) / r: 761 bits, 24 limbs LE */
static const uint32_t HARD_EXP_W[24] = {
  0xCCDF42B1, 0xE81BB482, 0xF49C36D4, 0x5ABF5CC4, 0x1DA014FD, 0xF1154E7E,
  0x87CDBACF, 0xDCC7B44C, 0x954BCF8A, 0xAAA441E3, 0xD5095F23, 0x6B887D56,
  0xF3FD90C6, 0x79581E16, 0xD189227D, 0x3B1B1355, 0x61876F6B, 0x4E529A58,
  0xD5B12278, 0x6C0EB522, 0x83177FAF, 0x331EC151, 0x0B0759AD, 0x01BAAA71};
#define HARD_EXP_BITS 761

/* bits of ate loop 6x+2 after the leading 1, MSB first (64 bits) */
static const uint8_t ATE_BITS[64] = {
  1,0,0,1,1,1,0,1,0,1,1,1,1,0,0,1,0,1,1,1,0,0,0,0,0,0,1,1,1,0,0,1,
  1,0,1,1,1,1,1,0,0,1,1,1,0,1,1,0,0,0,1,1,1,0,1,1,1,0,1,0,1,0,0,0};

static u256 PM;                 /* the modulus p (set in pairing_check) */

/* -- Fp ---------------------------------------------------------------- */

static void fp_mul(u256 *r, const u256 *a, const u256 *b) {
  u256_modmul_raw(r, a, b, &PM);
}

static void fp_add(u256 *r, const u256 *a, const u256 *b) {
  uint32_t c = u256_add(r, a, b);
  if (c || u256_cmp(r, &PM) >= 0) u256_sub(r, r, &PM);
}

static void fp_sub(u256 *r, const u256 *a, const u256 *b) {
  if (u256_cmp(a, b) >= 0) {
    u256_sub(r, a, b);
  } else {
    u256 t;
    u256_sub(&t, b, a);
    u256_sub(r, &PM, &t);
  }
}

static void fp_neg(u256 *r, const u256 *a) {
  if (u256_is_zero(a)) {
    u256_zero(r);
  } else {
    u256_sub(r, &PM, a);
  }
}

static void fp_inv(u256 *r, const u256 *a) {
  u256 e, two, acc, base;
  uint32_t bl, i;
  u256_from_u32(&two, 2);
  u256_sub(&e, &PM, &two);
  u256_from_u32(&acc, 1);
  base = *a;
  bl = u256_bitlen(&e);
  for (i = 0; i < bl; i++) {
    if (u256_bit(&e, i)) fp_mul(&acc, &acc, &base);
    if (i + 1 < bl) fp_mul(&base, &base, &base);
  }
  *r = acc;
}

/* -- Fp2: a + b*u ------------------------------------------------------ */

typedef struct { u256 a, b; } f2;

static void f2_zero(f2 *r) { u256_zero(&r->a); u256_zero(&r->b); }
static void f2_one(f2 *r)  { u256_from_u32(&r->a, 1); u256_zero(&r->b); }

static uint32_t f2_is_zero(const f2 *x) {
  return u256_is_zero(&x->a) && u256_is_zero(&x->b);
}

static uint32_t f2_eq(const f2 *x, const f2 *y) {
  return u256_eq(&x->a, &y->a) && u256_eq(&x->b, &y->b);
}

static void f2_add(f2 *r, const f2 *x, const f2 *y) {
  fp_add(&r->a, &x->a, &y->a);
  fp_add(&r->b, &x->b, &y->b);
}

static void f2_sub(f2 *r, const f2 *x, const f2 *y) {
  fp_sub(&r->a, &x->a, &y->a);
  fp_sub(&r->b, &x->b, &y->b);
}

static void f2_neg(f2 *r, const f2 *x) {
  fp_neg(&r->a, &x->a);
  fp_neg(&r->b, &x->b);
}

static void f2_conj(f2 *r, const f2 *x) {
  r->a = x->a;
  fp_neg(&r->b, &x->b);
}

static void f2_mul(f2 *r, const f2 *x, const f2 *y) {
  /* karatsuba: (a0b0 - a1b1, (a0+a1)(b0+b1) - a0b0 - a1b1) */
  u256 p0, p1, sx, sy, t;
  fp_mul(&p0, &x->a, &y->a);
  fp_mul(&p1, &x->b, &y->b);
  fp_add(&sx, &x->a, &x->b);
  fp_add(&sy, &y->a, &y->b);
  fp_mul(&t, &sx, &sy);
  fp_sub(&t, &t, &p0);
  fp_sub(&t, &t, &p1);
  fp_sub(&r->a, &p0, &p1);
  r->b = t;
}

static void f2_small(f2 *r, uint32_t re, uint32_t im) {
  u256_from_u32(&r->a, re);
  u256_from_u32(&r->b, im);
}

static void f2_scalar_u32(f2 *r, const f2 *x, uint32_t k) {
  u256 kk;
  u256_from_u32(&kk, k);
  fp_mul(&r->a, &x->a, &kk);
  fp_mul(&r->b, &x->b, &kk);
}

static void f2_inv(f2 *r, const f2 *x) {
  u256 n, t, d;
  fp_mul(&n, &x->a, &x->a);
  fp_mul(&t, &x->b, &x->b);
  fp_add(&n, &n, &t);
  fp_inv(&d, &n);
  fp_mul(&r->a, &x->a, &d);
  fp_mul(&t, &x->b, &d);
  fp_neg(&r->b, &t);
}

/* xi = 9 + u (the sextic twist constant) */
static void f2_mul_xi(f2 *r, const f2 *x) {
  f2 xi, t;
  f2_small(&xi, 9, 1);
  f2_mul(&t, x, &xi);
  *r = t;
}

/* -- Fp6: c0 + c1 v + c2 v^2, v^3 = xi --------------------------------- */

typedef struct { f2 c0, c1, c2; } f6;

static void f6_zero(f6 *r) { f2_zero(&r->c0); f2_zero(&r->c1); f2_zero(&r->c2); }
static void f6_one(f6 *r)  { f2_one(&r->c0); f2_zero(&r->c1); f2_zero(&r->c2); }

static void f6_add(f6 *r, const f6 *x, const f6 *y) {
  f2_add(&r->c0, &x->c0, &y->c0);
  f2_add(&r->c1, &x->c1, &y->c1);
  f2_add(&r->c2, &x->c2, &y->c2);
}

static void f6_sub(f6 *r, const f6 *x, const f6 *y) {
  f2_sub(&r->c0, &x->c0, &y->c0);
  f2_sub(&r->c1, &x->c1, &y->c1);
  f2_sub(&r->c2, &x->c2, &y->c2);
}

static void f6_neg(f6 *r, const f6 *x) {
  f2_neg(&r->c0, &x->c0);
  f2_neg(&r->c1, &x->c1);
  f2_neg(&r->c2, &x->c2);
}

static void f6_mul(f6 *r, const f6 *x, const f6 *y) {
  f2 a, b, c, t0, t1, t2, s1, s2;
  f2_mul(&a, &x->c0, &y->c0);
  f2_mul(&b, &x->c1, &y->c1);
  f2_mul(&c, &x->c2, &y->c2);
  /* t0 = a + xi*((x1+x2)(y1+y2) - b - c) */
  f2_add(&s1, &x->c1, &x->c2);
  f2_add(&s2, &y->c1, &y->c2);
  f2_mul(&t0, &s1, &s2);
  f2_sub(&t0, &t0, &b);
  f2_sub(&t0, &t0, &c);
  f2_mul_xi(&t0, &t0);
  f2_add(&t0, &t0, &a);
  /* t1 = (x0+x1)(y0+y1) - a - b + xi*c */
  f2_add(&s1, &x->c0, &x->c1);
  f2_add(&s2, &y->c0, &y->c1);
  f2_mul(&t1, &s1, &s2);
  f2_sub(&t1, &t1, &a);
  f2_sub(&t1, &t1, &b);
  f2_mul_xi(&s1, &c);
  f2_add(&t1, &t1, &s1);
  /* t2 = (x0+x2)(y0+y2) - a - c + b */
  f2_add(&s1, &x->c0, &x->c2);
  f2_add(&s2, &y->c0, &y->c2);
  f2_mul(&t2, &s1, &s2);
  f2_sub(&t2, &t2, &a);
  f2_sub(&t2, &t2, &c);
  f2_add(&t2, &t2, &b);
  r->c0 = t0;
  r->c1 = t1;
  r->c2 = t2;
}

static void f6_inv(f6 *r, const f6 *x) {
  f2 c0, c1, c2, t, s;
  /* c0 = x0^2 - xi*x1*x2 */
  f2_mul(&c0, &x->c0, &x->c0);
  f2_mul(&t, &x->c1, &x->c2);
  f2_mul_xi(&t, &t);
  f2_sub(&c0, &c0, &t);
  /* c1 = xi*x2^2 - x0*x1 */
  f2_mul(&c1, &x->c2, &x->c2);
  f2_mul_xi(&c1, &c1);
  f2_mul(&t, &x->c0, &x->c1);
  f2_sub(&c1, &c1, &t);
  /* c2 = x1^2 - x0*x2 */
  f2_mul(&c2, &x->c1, &x->c1);
  f2_mul(&t, &x->c0, &x->c2);
  f2_sub(&c2, &c2, &t);
  /* t = 1 / (x0*c0 + xi*(x2*c1 + x1*c2)) */
  f2_mul(&t, &x->c2, &c1);
  f2_mul(&s, &x->c1, &c2);
  f2_add(&t, &t, &s);
  f2_mul_xi(&t, &t);
  f2_mul(&s, &x->c0, &c0);
  f2_add(&t, &t, &s);
  f2_inv(&t, &t);
  f2_mul(&r->c0, &c0, &t);
  f2_mul(&r->c1, &c1, &t);
  f2_mul(&r->c2, &c2, &t);
}

/* x * v: (c0, c1, c2) -> (xi*c2, c0, c1) */
static void f6_mul_v(f6 *r, const f6 *x) {
  f2 t;
  f2_mul_xi(&t, &x->c2);
  r->c2 = x->c1;
  r->c1 = x->c0;
  r->c0 = t;
}

/* -- Fp12: c0 + c1 w, w^2 = v ------------------------------------------ */

typedef struct { f6 c0, c1; } f12;

static void f12_one(f12 *r) { f6_one(&r->c0); f6_zero(&r->c1); }

static uint32_t f12_is_one(const f12 *x) {
  f12 one;
  f12_one(&one);
  return memcmp(x, &one, sizeof(f12)) == 0;
}

static void f12_mul(f12 *r, const f12 *x, const f12 *y) {
  f6 a, b, bv, s1, s2, t;
  f6_mul(&a, &x->c0, &y->c0);
  f6_mul(&b, &x->c1, &y->c1);
  f6_mul_v(&bv, &b);
  f6_add(&s1, &x->c0, &x->c1);
  f6_add(&s2, &y->c0, &y->c1);
  f6_mul(&t, &s1, &s2);
  f6_sub(&t, &t, &a);
  f6_sub(&t, &t, &b);
  f6_add(&r->c0, &a, &bv);
  r->c1 = t;
}

static void f12_sq(f12 *r, const f12 *x) {
  f12_mul(r, x, x);
}

static void f12_conj(f12 *r, const f12 *x) {
  r->c0 = x->c0;
  f6_neg(&r->c1, &x->c1);
}

static void f12_inv(f12 *r, const f12 *x) {
  f6 b2, b2v, t;
  f6_mul(&b2, &x->c1, &x->c1);
  f6_mul_v(&b2v, &b2);
  f6_mul(&t, &x->c0, &x->c0);
  f6_sub(&t, &t, &b2v);
  f6_inv(&t, &t);
  f6_mul(&r->c0, &x->c0, &t);
  f6_mul(&b2, &x->c1, &t);
  f6_neg(&r->c1, &b2);
}

static void load_g1f(f2 *r, uint32_t i) {      /* i = 1..5 */
  memcpy(r->a.w, G1F_RE[i - 1], 32);
  memcpy(r->b.w, G1F_IM[i - 1], 32);
}

static void f6_frob(f6 *r, const f6 *x) {
  f2 g2, g4, t;
  load_g1f(&g2, 2);
  load_g1f(&g4, 4);
  f2_conj(&r->c0, &x->c0);
  f2_conj(&t, &x->c1);
  f2_mul(&r->c1, &t, &g2);
  f2_conj(&t, &x->c2);
  f2_mul(&r->c2, &t, &g4);
}

static void f12_frob(f12 *r, const f12 *x) {
  f2 g1, g3, g5, t;
  f6 c1;
  load_g1f(&g1, 1);
  load_g1f(&g3, 3);
  load_g1f(&g5, 5);
  f6_frob(&r->c0, &x->c0);
  f2_conj(&t, &x->c1.c0);
  f2_mul(&c1.c0, &t, &g1);
  f2_conj(&t, &x->c1.c1);
  f2_mul(&c1.c1, &t, &g3);
  f2_conj(&t, &x->c1.c2);
  f2_mul(&c1.c2, &t, &g5);
  r->c1 = c1;
}

/* -- curve points -------------------------------------------------------
 * G1: affine (x, y) over Fp, y^2 = x^3 + 3; inf flagged.
 * G2: affine over Fp2, y^2 = x^3 + 3/xi. */

typedef struct { u256 x, y; uint32_t inf; } g1pt;
typedef struct { f2 x, y; uint32_t inf; } g2pt;

static uint32_t g1_valid(const g1pt *p) {
  u256 y2, x3, t;
  if (p->inf) return 1;
  fp_mul(&y2, &p->y, &p->y);
  fp_mul(&x3, &p->x, &p->x);
  fp_mul(&x3, &x3, &p->x);
  u256_from_u32(&t, 3);
  fp_add(&x3, &x3, &t);
  return u256_eq(&y2, &x3);
}

static void g2_b(f2 *r) {           /* 3 / xi */
  f2 three, xi;
  f2_small(&three, 3, 0);
  f2_small(&xi, 9, 1);
  f2_inv(&xi, &xi);
  f2_mul(r, &three, &xi);
}

static uint32_t g2_valid(const g2pt *p) {
  f2 lhs, rhs, b;
  if (p->inf) return 1;
  f2_mul(&lhs, &p->y, &p->y);
  f2_mul(&rhs, &p->x, &p->x);
  f2_mul(&rhs, &rhs, &p->x);
  g2_b(&b);
  f2_add(&rhs, &rhs, &b);
  return f2_eq(&lhs, &rhs);
}

static void g2_add_pt(g2pt *r, const g2pt *p1, const g2pt *p2) {
  f2 s, t, t2;
  g2pt o;
  if (p1->inf) { *r = *p2; return; }
  if (p2->inf) { *r = *p1; return; }
  if (f2_eq(&p1->x, &p2->x)) {
    if (!f2_eq(&p1->y, &p2->y) || f2_is_zero(&p1->y)) {
      o.inf = 1;
      f2_zero(&o.x);
      f2_zero(&o.y);
      *r = o;
      return;
    }
    f2_mul(&t, &p1->x, &p1->x);
    f2_scalar_u32(&t, &t, 3);
    f2_scalar_u32(&t2, &p1->y, 2);
    f2_inv(&t2, &t2);
    f2_mul(&s, &t, &t2);
  } else {
    f2_sub(&t, &p2->y, &p1->y);
    f2_sub(&t2, &p2->x, &p1->x);
    f2_inv(&t2, &t2);
    f2_mul(&s, &t, &t2);
  }
  f2_mul(&t, &s, &s);
  f2_sub(&t, &t, &p1->x);
  f2_sub(&o.x, &t, &p2->x);
  f2_sub(&t, &p1->x, &o.x);
  f2_mul(&t, &s, &t);
  f2_sub(&o.y, &t, &p1->y);
  o.inf = 0;
  *r = o;
}

static uint32_t g2_in_subgroup(const g2pt *p) {
  g2pt acc, base;
  u256 k;
  uint32_t bl, i;
  memcpy(k.w, BN_R_W, 32);
  acc.inf = 1;
  f2_zero(&acc.x);
  f2_zero(&acc.y);
  base = *p;
  bl = u256_bitlen(&k);
  for (i = 0; i < bl; i++) {
    if (u256_bit(&k, i)) g2_add_pt(&acc, &acc, &base);
    if (i + 1 < bl) g2_add_pt(&base, &base, &base);
  }
  return acc.inf;
}

/* line through q1, q2 evaluated at p, as a (sparse) full Fp12 element.
 * Mirrors app/bn254.py::_line exactly (D-twist untwist). */
static void line_eval(f12 *r, const g2pt *q1, const g2pt *q2,
                      const g1pt *p) {
  f2 s, t, t2;
  f6_zero(&r->c0);
  f6_zero(&r->c1);
  if (f2_eq(&q1->x, &q2->x) && f2_eq(&q1->y, &q2->y)) {
    f2_mul(&t, &q1->x, &q1->x);
    f2_scalar_u32(&t, &t, 3);
    f2_scalar_u32(&t2, &q1->y, 2);
    f2_inv(&t2, &t2);
    f2_mul(&s, &t, &t2);
  } else if (f2_eq(&q1->x, &q2->x)) {
    /* vertical line: px - x' * v */
    r->c0.c0.a = p->x;
    u256_zero(&r->c0.c0.b);
    f2_neg(&r->c0.c1, &q1->x);
    return;
  } else {
    f2_sub(&t, &q2->y, &q1->y);
    f2_sub(&t2, &q2->x, &q1->x);
    f2_inv(&t2, &t2);
    f2_mul(&s, &t, &t2);
  }
  /* c0.a0 = py ; c1.c0 = -s*px ; c1.c1 = s*x' - y' */
  r->c0.c0.a = p->y;
  u256_zero(&r->c0.c0.b);
  f2_mul(&t, &s, &q1->x);
  f2_sub(&r->c1.c1, &t, &q1->y);
  {
    u256 npx;
    fp_neg(&npx, &p->x);
    fp_mul(&r->c1.c0.a, &s.a, &npx);
    fp_mul(&r->c1.c0.b, &s.b, &npx);
  }
}

static void miller_loop(f12 *f, const g2pt *q, const g1pt *p) {
  g2pt t, q1, nq2;
  f12 l;
  f2 g2c, g3c, cj, tmp;
  uint32_t i;
  f12_one(f);
  if (q->inf || p->inf) return;
  t = *q;
  for (i = 0; i < 64; i++) {
    f12_sq(f, f);
    line_eval(&l, &t, &t, p);
    f12_mul(f, f, &l);
    g2_add_pt(&t, &t, &t);
    if (ATE_BITS[i]) {
      line_eval(&l, &t, q, p);
      f12_mul(f, f, &l);
      g2_add_pt(&t, &t, q);
    }
  }
  /* Frobenius corrections: q1 = pi(q), -q2 = -pi^2(q) */
  load_g1f(&g2c, 2);
  load_g1f(&g3c, 3);
  f2_conj(&cj, &q->x);
  f2_mul(&q1.x, &cj, &g2c);
  f2_conj(&cj, &q->y);
  f2_mul(&q1.y, &cj, &g3c);
  q1.inf = 0;
  /* g22 = g2 * conj(g2), g23 = g3 * conj(g3) (both in Fp) */
  f2_conj(&cj, &g2c);
  f2_mul(&tmp, &g2c, &cj);
  f2_mul(&nq2.x, &q->x, &tmp);
  f2_conj(&cj, &g3c);
  f2_mul(&tmp, &g3c, &cj);
  f2_mul(&nq2.y, &q->y, &tmp);
  f2_neg(&nq2.y, &nq2.y);
  nq2.inf = 0;
  line_eval(&l, &t, &q1, p);
  f12_mul(f, f, &l);
  g2_add_pt(&t, &t, &q1);
  line_eval(&l, &t, &nq2, p);
  f12_mul(f, f, &l);
}

static void final_exponentiation(f12 *r, const f12 *f) {
  f12 f1, inv, fe, acc, base;
  uint32_t i;
  /* easy part: f^((p^6-1)(p^2+1)) */
  f12_conj(&f1, f);
  f12_inv(&inv, f);
  f12_mul(&f1, &f1, &inv);
  f12_frob(&fe, &f1);
  f12_frob(&fe, &fe);
  f12_mul(&fe, &fe, &f1);
  /* hard part: ^((p^4 - p^2 + 1)/r), plain square-and-multiply */
  f12_one(&acc);
  base = fe;
  for (i = 0; i < HARD_EXP_BITS; i++) {
    if ((HARD_EXP_W[i >> 5] >> (i & 31)) & 1) f12_mul(&acc, &acc, &base);
    if (i + 1 < HARD_EXP_BITS) f12_sq(&base, &base);
  }
  *r = acc;
}

int bn254_pairing_check(const uint8_t *input, uint32_t len) {
  f12 f, m, fr;
  uint32_t off;
  if (len % 192 != 0) return -1;
  memcpy(PM.w, BN_P_W, 32);
  f12_one(&f);
  for (off = 0; off + 192 <= len; off += 192) {
    g1pt p1;
    g2pt q2;
    /* EVM G2 encoding: imaginary limb first */
    u256_from_be(&p1.x, input + off);
    u256_from_be(&p1.y, input + off + 32);
    u256_from_be(&q2.x.b, input + off + 64);
    u256_from_be(&q2.x.a, input + off + 96);
    u256_from_be(&q2.y.b, input + off + 128);
    u256_from_be(&q2.y.a, input + off + 160);
    if (u256_cmp(&p1.x, &PM) >= 0 || u256_cmp(&p1.y, &PM) >= 0
        || u256_cmp(&q2.x.a, &PM) >= 0 || u256_cmp(&q2.x.b, &PM) >= 0
        || u256_cmp(&q2.y.a, &PM) >= 0 || u256_cmp(&q2.y.b, &PM) >= 0)
      return -1;
    p1.inf = u256_is_zero(&p1.x) && u256_is_zero(&p1.y);
    q2.inf = f2_is_zero(&q2.x) && f2_is_zero(&q2.y);
    if (!g1_valid(&p1)) return -1;
    if (!g2_valid(&q2)) return -1;
    if (!q2.inf && !g2_in_subgroup(&q2)) return -1;
    if (p1.inf || q2.inf) continue;
    miller_loop(&m, &q2, &p1);
    f12_mul(&f, &f, &m);
  }
  final_exponentiation(&fr, &f);
  return f12_is_one(&fr) ? 1 : 0;
}
