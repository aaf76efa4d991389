/* BLS12-381 pairing + KZG point-evaluation verify (guest side).
 *
 * Mirror of the host engine's zeth_tpu/app/bls12381.py + app/kzg.py
 * (reference: the guest's blst/c-kzg patches over risc0-bigint2,
 * SURVEY.md §2.2 guest crypto patches). Tower Fp2 = Fp[u]/(u^2+1),
 * Fp6 = Fp2[v]/(v^3 - (1+u)), Fp12 = Fp6[w]/(w^2 - v); affine Miller
 * loop over the |x| bits with the negative-parameter conjugation;
 * final exponentiation: Frobenius easy part + plain square-and-multiply
 * hard part (1268-bit exponent). Every Fp mulmod is one 384-bit
 * SYS_BIGINT accelerator call; scalar muls run in Jacobian coordinates
 * so only the Miller loop pays per-step field inversions.
 */
#include <stdint.h>
#include <string.h>
#include "zeth.h"
#include "bls381.h"

/* -- constants (little-endian u32 limbs; derived in app/bls12381.py) -- */

static const uint32_t BLS_P_W[12] = {
  0xFFFFAAAB, 0xB9FEFFFF, 0xB153FFFF, 0x1EABFFFE,
  0xF6B0F624, 0x6730D2A0, 0xF38512BF, 0x64774B84,
  0x434BACD7, 0x4B1BA7B6, 0x397FE69A, 0x1A0111EA};
static const uint32_t BLS_R_W[12] = {
  0x00000001, 0xFFFFFFFF, 0xFFFE5BFE, 0x53BDA402,
  0x09A1D805, 0x3339D808, 0x299D7D48, 0x73EDA753,
  0x00000000, 0x00000000, 0x00000000, 0x00000000};
static const uint32_t P_MINUS_2_W[12] = {
  0xFFFFAAA9, 0xB9FEFFFF, 0xB153FFFF, 0x1EABFFFE,
  0xF6B0F624, 0x6730D2A0, 0xF38512BF, 0x64774B84,
  0x434BACD7, 0x4B1BA7B6, 0x397FE69A, 0x1A0111EA};
static const uint32_t SQRT_EXP_W[12] = {          /* (p+1)/4 */
  0xFFFFEAAB, 0xEE7FBFFF, 0xAC54FFFF, 0x07AAFFFF,
  0x3DAC3D89, 0xD9CC34A8, 0x3CE144AF, 0xD91DD2E1,
  0x90D2EB35, 0x92C6E9ED, 0x8E5FF9A6, 0x0680447A};
/* (p^4 - p^2 + 1) / r, 1268 bits */
static const uint32_t BLS_HARD_EXP_W[48] = {
  0x38E3BA79, 0xE516C3F4, 0xE208CCF1, 0xFA9912AA,
  0x335D5B68, 0x905CE937, 0xB0DEA236, 0xC71A2629,
  0x996754C8, 0x83774940, 0xB6A1E799, 0x21D160AE,
  0xED237DB4, 0x2ED0B283, 0x6C6F1821, 0x915C97F3,
  0xDE783765, 0x67F17FCB, 0x9096D1B7, 0x2378B903,
  0x1BDC51DC, 0x7988F876, 0x03FC77A1, 0x20769950,
  0xA621315B, 0x827ECA0B, 0x8D63CB9F, 0xE5A72BCE,
  0xC28B6F8A, 0xF68F7764, 0xCF081517, 0x2F230063,
  0x528D6A9A, 0x94506632, 0xEB996CA3, 0xD3CDE88E,
  0x195C899E, 0xC0BD38C3, 0x3D807D01, 0x000F686B,
  0x00000000, 0x00000000, 0x00000000, 0x00000000,
  0x00000000, 0x00000000, 0x00000000, 0x00000000};
#define BLS_HARD_EXP_BITS 1268

/* Frobenius gammas G1F[i] = (1+u)^(i(p-1)/6) */
static const uint32_t BLSG1F1_RE[12] = {
  0x92235FB8, 0x8D0775ED, 0x63E7813D, 0xF67EA53D,
  0x84BAB9C4, 0x7B2443D7, 0x3CBD5F4F, 0x0FD603FD,
  0x202C0D1F, 0xC231BEB4, 0x02BB0667, 0x1904D3BF};
static const uint32_t BLSG1F1_IM[12] = {
  0x6DDC4AF3, 0x2CF78A12, 0x4D6C7EC2, 0x282D5AC1,
  0x71F63C5F, 0xEC0C8EC9, 0xB6C7B36F, 0x54A14787,
  0x231F9FB8, 0x88E9E902, 0x36C4E032, 0x00FC3E2B};
static const uint32_t BLSG1F2_IM[12] = {
  0x0000AAAC, 0x8BFD0000, 0x4F49FFFD, 0x409427EB,
  0x0FB85F9B, 0x897D2965, 0x89759AD4, 0xAA0D857D,
  0x63D4DE85, 0xEC024086, 0x397FE699, 0x1A0111EA};
static const uint32_t BLSG1F3_RE[12] = {
  0xEDE3CC09, 0xC81084FB, 0x72EC05F4, 0xEE67992F,
  0x009241C5, 0x77F76E17, 0xC2D3435E, 0x48395DAB,
  0x6BD17FFE, 0x6831E36D, 0x37FF400B, 0x06AF0E04};
static const uint32_t BLSG1F4_RE[12] = {
  0x0000AAAD, 0x8BFD0000, 0x4F49FFFD, 0x409427EB,
  0x0FB85F9B, 0x897D2965, 0x89759AD4, 0xAA0D857D,
  0x63D4DE85, 0xEC024086, 0x397FE699, 0x1A0111EA};
static const uint32_t BLSG1F5_RE[12] = {
  0x80078116, 0x9B18FAE9, 0x257F8732, 0xC63A3E6E,
  0x8E9C0566, 0x8BEADF4D, 0x0C0B8FEE, 0xF3981624,
  0x48B1E045, 0xDF47FA6B, 0x013A5FD8, 0x05B2CFD9};
static const uint32_t BLSG1F5_IM[12] = {
  0x7FF82995, 0x1EE60516, 0x8BD478CD, 0x5871C190,
  0x6814F0BD, 0xDB45F353, 0xE77982D0, 0x70DF3560,
  0xFA99CC91, 0x6BD3AD4A, 0x384586C1, 0x144E4211};

static const uint32_t BLSG1X_W[12] = {
  0xDB22C6BB, 0xFB3AF00A, 0xF97A1AEF, 0x6C55E83F,
  0x171BAC58, 0xA14E3A3F, 0x9774B905, 0xC3688C4F,
  0x4FA9AC0F, 0x2695638C, 0x3197D794, 0x17F1D3A7};
static const uint32_t BLSG1Y_W[12] = {
  0x46C5E7E1, 0x0CAA2329, 0xA2888AE4, 0xD03CC744,
  0x2C04B3ED, 0x00DB18CB, 0xD5D00AF6, 0xFCF5E095,
  0x741D8AE4, 0xA09E30ED, 0xE3AAA0F1, 0x08B3F481};
static const uint32_t BLSG2X0_W[12] = {
  0xC121BDB8, 0xD48056C8, 0xA805BBEF, 0x0BAC0326,
  0x7AE3D177, 0xB4510B64, 0xFA403B02, 0xC6E47AD4,
  0x2DC51051, 0x26080527, 0xF08F0A91, 0x024AA2B2};
static const uint32_t BLSG2X1_W[12] = {
  0x5D042B7E, 0xE5AC7D05, 0x13945D57, 0x334CF112,
  0xDC7F5049, 0xB5DA61BB, 0x9920B61A, 0x596BD0D0,
  0x88274F65, 0x7DACD3A0, 0x52719F60, 0x13E02B60};
static const uint32_t BLSG2Y0_W[12] = {
  0x08B82801, 0xE1935486, 0x3BACA289, 0x923AC9CC,
  0x5160D12C, 0x6D429A69, 0x8CBDD3A7, 0xADFD9BAA,
  0xDA2E351A, 0x8CC9CDC6, 0x727D6E11, 0x0CE5D527};
static const uint32_t BLSG2Y1_W[12] = {
  0xF05F79BE, 0xAAA9075F, 0x5CEC1DA1, 0x3F370D27,
  0x572E99AB, 0x267492AB, 0x85A763AF, 0xCB3E287E,
  0x2BC28B99, 0x32ACD2B0, 0x2EA734CC, 0x0606C4A0};

/* |x| bits after the leading 1, MSB first (x = -0xd201000000010000) */
static const uint8_t BLS_X_BITS[63] = {
  1,0,1,0,0,1,0,0,0,0,0,0,0,0,1,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
  0,0,0,0,0,0,0,0,0,0,0,0,0,0,1,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0};

/* -- Fp: 12 little-endian u32 limbs ------------------------------------ */

typedef struct { uint32_t w[12]; } blsfp;

static uint32_t blsfp_add_raw(blsfp *r, const blsfp *a, const blsfp *b) {
  uint32_t c = 0, i;
  for (i = 0; i < 12; i++) {
    uint32_t s = a->w[i] + c;
    uint32_t c1 = s < c;
    uint32_t t = s + b->w[i];
    c = c1 | (t < s);
    r->w[i] = t;
  }
  return c;
}

static uint32_t blsfp_sub_raw(blsfp *r, const blsfp *a, const blsfp *b) {
  uint32_t brw = 0, i;
  for (i = 0; i < 12; i++) {
    uint32_t d = a->w[i] - b->w[i] - brw;
    brw = (a->w[i] < b->w[i]) |
          ((a->w[i] == b->w[i]) & brw);
    r->w[i] = d;
  }
  return brw;
}

static int blsfp_cmp(const blsfp *a, const blsfp *b) {
  int i;
  for (i = 11; i >= 0; i--) {
    if (a->w[i] != b->w[i]) return a->w[i] > b->w[i] ? 1 : -1;
  }
  return 0;
}

static uint32_t blsfp_is_zero(const blsfp *a) {
  uint32_t acc = 0, i;
  for (i = 0; i < 12; i++) acc |= a->w[i];
  return acc == 0;
}

static uint32_t blsfp_eq(const blsfp *a, const blsfp *b) {
  return blsfp_cmp(a, b) == 0;
}

static blsfp BLS_FP_P;                  /* the modulus, set in bls_init */

static void blsfp_add(blsfp *r, const blsfp *a, const blsfp *b) {
  uint32_t c = blsfp_add_raw(r, a, b);
  if (c || blsfp_cmp(r, &BLS_FP_P) >= 0) blsfp_sub_raw(r, r, &BLS_FP_P);
}

static void blsfp_sub(blsfp *r, const blsfp *a, const blsfp *b) {
  if (blsfp_cmp(a, b) >= 0) {
    blsfp_sub_raw(r, a, b);
  } else {
    blsfp t;
    blsfp_sub_raw(&t, b, a);
    blsfp_sub_raw(r, &BLS_FP_P, &t);
  }
}

static void blsfp_neg(blsfp *r, const blsfp *a) {
  if (blsfp_is_zero(a)) { *r = *a; return; }
  blsfp_sub_raw(r, &BLS_FP_P, a);
}

/* 384-bit accelerator IO block: [a | b | m | r], 12 words each */
static uint32_t bls_io[48];

static void blsfp_mul(blsfp *r, const blsfp *a, const blsfp *b) {
  memcpy(bls_io, a->w, 48);
  memcpy(bls_io + 12, b->w, 48);
  memcpy(bls_io + 24, BLS_FP_P.w, 48);
  sys_bigint_modmul(bls_io);
  memcpy(r->w, bls_io + 36, 48);
}

static void blsfp_pow_w(blsfp *r, const blsfp *a, const uint32_t *e, uint32_t bits) {
  blsfp acc, base;
  uint32_t i;
  memset(&acc, 0, sizeof acc);
  acc.w[0] = 1;
  base = *a;
  for (i = 0; i < bits; i++) {
    if ((e[i >> 5] >> (i & 31)) & 1) blsfp_mul(&acc, &acc, &base);
    if (i + 1 < bits) blsfp_mul(&base, &base, &base);
  }
  *r = acc;
}

static void blsfp_inv(blsfp *r, const blsfp *a) {
  blsfp_pow_w(r, a, P_MINUS_2_W, 381);
}

/* sqrt via (p+1)/4 (p = 3 mod 4); returns 1 and sets r when a is a QR */
static uint32_t blsfp_sqrt(blsfp *r, const blsfp *a) {
  blsfp cand, sq;
  blsfp_pow_w(&cand, a, SQRT_EXP_W, 379);
  blsfp_mul(&sq, &cand, &cand);
  if (!blsfp_eq(&sq, a)) return 0;
  *r = cand;
  return 1;
}

static void blsfp_from_w(blsfp *r, const uint32_t *w) { memcpy(r->w, w, 48); }

static void blsfp_from_be48(blsfp *r, const uint8_t *be) {
  uint32_t i;
  for (i = 0; i < 12; i++) {
    const uint8_t *p = be + 44 - 4 * i;
    r->w[i] = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
              ((uint32_t)p[2] << 8) | p[3];
  }
}

/* -- Fp2: a + b*u, u^2 = -1 -------------------------------------------- */

typedef struct { blsfp a, b; } blsf2;

static void blsf2_zero(blsf2 *r) { memset(r, 0, sizeof *r); }

static uint32_t blsf2_is_zero(const blsf2 *x) {
  return blsfp_is_zero(&x->a) && blsfp_is_zero(&x->b);
}

static uint32_t blsf2_eq(const blsf2 *x, const blsf2 *y) {
  return blsfp_eq(&x->a, &y->a) && blsfp_eq(&x->b, &y->b);
}

static void blsf2_add(blsf2 *r, const blsf2 *x, const blsf2 *y) {
  blsfp_add(&r->a, &x->a, &y->a);
  blsfp_add(&r->b, &x->b, &y->b);
}

static void blsf2_sub(blsf2 *r, const blsf2 *x, const blsf2 *y) {
  blsfp_sub(&r->a, &x->a, &y->a);
  blsfp_sub(&r->b, &x->b, &y->b);
}

static void blsf2_neg(blsf2 *r, const blsf2 *x) {
  blsfp_neg(&r->a, &x->a);
  blsfp_neg(&r->b, &x->b);
}

static void blsf2_mul(blsf2 *r, const blsf2 *x, const blsf2 *y) {
  blsfp t1, t2, t3, sa, sb;
  blsfp_mul(&t1, &x->a, &y->a);
  blsfp_mul(&t2, &x->b, &y->b);
  blsfp_add(&sa, &x->a, &x->b);
  blsfp_add(&sb, &y->a, &y->b);
  blsfp_mul(&t3, &sa, &sb);
  blsf2 out;
  blsfp_sub(&out.a, &t1, &t2);
  blsfp_sub(&t3, &t3, &t1);
  blsfp_sub(&out.b, &t3, &t2);
  *r = out;
}

static void blsf2_mul_fp(blsf2 *r, const blsf2 *x, const blsfp *k) {
  blsfp_mul(&r->a, &x->a, k);
  blsfp_mul(&r->b, &x->b, k);
}

static void blsf2_inv(blsf2 *r, const blsf2 *x) {
  blsfp n, t, d;
  blsfp_mul(&n, &x->a, &x->a);
  blsfp_mul(&t, &x->b, &x->b);
  blsfp_add(&n, &n, &t);
  blsfp_inv(&d, &n);
  blsf2 out;
  blsfp_mul(&out.a, &x->a, &d);
  blsfp_mul(&t, &x->b, &d);
  blsfp_neg(&out.b, &t);
  *r = out;
}

static void blsf2_conj(blsf2 *r, const blsf2 *x) {
  r->a = x->a;
  blsfp_neg(&r->b, &x->b);
}

/* multiply by XI = 1 + u: (a + bu)(1 + u) = (a - b) + (a + b)u */
static void blsf2_mul_xi(blsf2 *r, const blsf2 *x) {
  blsfp na, nb;
  blsfp_sub(&na, &x->a, &x->b);
  blsfp_add(&nb, &x->a, &x->b);
  r->a = na;
  r->b = nb;
}

/* -- Fp6: c0 + c1 v + c2 v^2, v^3 = XI ---------------------------------- */

typedef struct { blsf2 c0, c1, c2; } blsf6;

static void blsf6_zero(blsf6 *r) { memset(r, 0, sizeof *r); }

static void blsf6_add(blsf6 *r, const blsf6 *x, const blsf6 *y) {
  blsf2_add(&r->c0, &x->c0, &y->c0);
  blsf2_add(&r->c1, &x->c1, &y->c1);
  blsf2_add(&r->c2, &x->c2, &y->c2);
}

static void blsf6_sub(blsf6 *r, const blsf6 *x, const blsf6 *y) {
  blsf2_sub(&r->c0, &x->c0, &y->c0);
  blsf2_sub(&r->c1, &x->c1, &y->c1);
  blsf2_sub(&r->c2, &x->c2, &y->c2);
}

static void blsf6_neg(blsf6 *r, const blsf6 *x) {
  blsf2_neg(&r->c0, &x->c0);
  blsf2_neg(&r->c1, &x->c1);
  blsf2_neg(&r->c2, &x->c2);
}

static void blsf6_mul(blsf6 *r, const blsf6 *x, const blsf6 *y) {
  blsf2 t0, t1, t2, s1, s2, tmp;
  blsf6 out;
  blsf2_mul(&t0, &x->c0, &y->c0);
  blsf2_mul(&t1, &x->c1, &y->c1);
  blsf2_mul(&t2, &x->c2, &y->c2);
  /* c0 = t0 + xi*((x1+x2)(y1+y2) - t1 - t2) */
  blsf2_add(&s1, &x->c1, &x->c2);
  blsf2_add(&s2, &y->c1, &y->c2);
  blsf2_mul(&tmp, &s1, &s2);
  blsf2_sub(&tmp, &tmp, &t1);
  blsf2_sub(&tmp, &tmp, &t2);
  blsf2_mul_xi(&tmp, &tmp);
  blsf2_add(&out.c0, &t0, &tmp);
  /* c1 = (x0+x1)(y0+y1) - t0 - t1 + xi*t2 */
  blsf2_add(&s1, &x->c0, &x->c1);
  blsf2_add(&s2, &y->c0, &y->c1);
  blsf2_mul(&tmp, &s1, &s2);
  blsf2_sub(&tmp, &tmp, &t0);
  blsf2_sub(&tmp, &tmp, &t1);
  blsf2 xt2;
  blsf2_mul_xi(&xt2, &t2);
  blsf2_add(&out.c1, &tmp, &xt2);
  /* c2 = (x0+x2)(y0+y2) - t0 - t2 + t1 */
  blsf2_add(&s1, &x->c0, &x->c2);
  blsf2_add(&s2, &y->c0, &y->c2);
  blsf2_mul(&tmp, &s1, &s2);
  blsf2_sub(&tmp, &tmp, &t0);
  blsf2_sub(&tmp, &tmp, &t2);
  blsf2_add(&out.c2, &tmp, &t1);
  *r = out;
}

/* multiply by v: (c0 + c1 v + c2 v^2) v = xi c2 + c0 v + c1 v^2 */
static void blsf6_mul_v(blsf6 *r, const blsf6 *x) {
  blsf6 out;
  blsf2_mul_xi(&out.c0, &x->c2);
  out.c1 = x->c0;
  out.c2 = x->c1;
  *r = out;
}

static void blsf6_inv(blsf6 *r, const blsf6 *x) {
  blsf2 c0, c1, c2, t, u0, u1, u2, n, ni;
  /* c0 = x0^2 - xi x1 x2; c1 = xi x2^2 - x0 x1; c2 = x1^2 - x0 x2 */
  blsf2_mul(&u0, &x->c0, &x->c0);
  blsf2_mul(&t, &x->c1, &x->c2);
  blsf2_mul_xi(&t, &t);
  blsf2_sub(&c0, &u0, &t);
  blsf2_mul(&u1, &x->c2, &x->c2);
  blsf2_mul_xi(&u1, &u1);
  blsf2_mul(&t, &x->c0, &x->c1);
  blsf2_sub(&c1, &u1, &t);
  blsf2_mul(&u2, &x->c1, &x->c1);
  blsf2_mul(&t, &x->c0, &x->c2);
  blsf2_sub(&c2, &u2, &t);
  /* n = x0 c0 + xi (x2 c1 + x1 c2) */
  blsf2_mul(&u0, &x->c2, &c1);
  blsf2_mul(&u1, &x->c1, &c2);
  blsf2_add(&t, &u0, &u1);
  blsf2_mul_xi(&t, &t);
  blsf2_mul(&u2, &x->c0, &c0);
  blsf2_add(&n, &u2, &t);
  blsf2_inv(&ni, &n);
  blsf2_mul(&r->c0, &c0, &ni);
  blsf2_mul(&r->c1, &c1, &ni);
  blsf2_mul(&r->c2, &c2, &ni);
}

/* -- Fp12: c0 + c1 w, w^2 = v ------------------------------------------- */

typedef struct { blsf6 c0, c1; } blsf12;

static void blsf12_one(blsf12 *r) {
  memset(r, 0, sizeof *r);
  r->c0.c0.a.w[0] = 1;
}

static uint32_t blsf12_is_one(const blsf12 *x) {
  blsf12 one;
  blsf12_one(&one);
  return memcmp(x, &one, sizeof one) == 0;
}

/* zeth-cc caps stack frames at 2 KB; Fp12-sized temporaries live at
 * file scope (one set per function — calls never share them). */
static blsf6 fm_t0, fm_t1, fm_s0, fm_s1, fm_tv;
static blsf12 fm_out;

static void blsf12_mul(blsf12 *r, const blsf12 *x, const blsf12 *y) {
  blsf6_mul(&fm_t0, &x->c0, &y->c0);
  blsf6_mul(&fm_t1, &x->c1, &y->c1);
  blsf6_mul_v(&fm_tv, &fm_t1);
  blsf6_add(&fm_out.c0, &fm_t0, &fm_tv);
  blsf6_add(&fm_s0, &x->c0, &x->c1);
  blsf6_add(&fm_s1, &y->c0, &y->c1);
  blsf6_mul(&fm_s0, &fm_s0, &fm_s1);
  blsf6_sub(&fm_s0, &fm_s0, &fm_t0);
  blsf6_sub(&fm_out.c1, &fm_s0, &fm_t1);
  *r = fm_out;
}

static void blsf12_sq(blsf12 *r, const blsf12 *x) { blsf12_mul(r, x, x); }

static void blsf12_conj(blsf12 *r, const blsf12 *x) {
  r->c0 = x->c0;
  blsf6_neg(&r->c1, &x->c1);
}

static void blsf12_inv(blsf12 *r, const blsf12 *x) {
  blsf6 t, u, ti;
  blsf6_mul(&t, &x->c0, &x->c0);
  blsf6_mul(&u, &x->c1, &x->c1);
  blsf6_mul_v(&u, &u);
  blsf6_sub(&t, &t, &u);
  blsf6_inv(&ti, &t);
  blsf6_mul(&r->c0, &x->c0, &ti);
  blsf6_mul(&u, &x->c1, &ti);
  blsf6_neg(&r->c1, &u);
}

static void blsf2_frob(blsf2 *r, const blsf2 *x) { blsf2_conj(r, x); }

static void blsf2_gamma(blsf2 *g, const uint32_t *re, const uint32_t *im) {
  blsfp_from_w(&g->a, re);
  if (im) blsfp_from_w(&g->b, im); else memset(&g->b, 0, sizeof g->b);
}

static blsf12 ff_out;

static void blsf12_frob(blsf12 *r, const blsf12 *x) {
  blsf2 g1, g2, g3, g4, g5, t;
  blsf2_gamma(&g1, BLSG1F1_RE, BLSG1F1_IM);
  memset(&g2, 0, sizeof g2);
  blsfp_from_w(&g2.b, BLSG1F2_IM);
  blsf2_gamma(&g3, BLSG1F3_RE, BLSG1F3_RE);   /* re == im for gamma_3 */
  memset(&g4, 0, sizeof g4);
  blsfp_from_w(&g4.a, BLSG1F4_RE);
  blsf2_gamma(&g5, BLSG1F5_RE, BLSG1F5_IM);
  /* c0: (conj(x00), conj(x01)*g2, conj(x02)*g4) */
  blsf2_frob(&ff_out.c0.c0, &x->c0.c0);
  blsf2_frob(&t, &x->c0.c1);
  blsf2_mul(&ff_out.c0.c1, &t, &g2);
  blsf2_frob(&t, &x->c0.c2);
  blsf2_mul(&ff_out.c0.c2, &t, &g4);
  /* c1: (conj(x10)*g1, conj(x11)*g3, conj(x12)*g5) */
  blsf2_frob(&t, &x->c1.c0);
  blsf2_mul(&ff_out.c1.c0, &t, &g1);
  blsf2_frob(&t, &x->c1.c1);
  blsf2_mul(&ff_out.c1.c1, &t, &g3);
  blsf2_frob(&t, &x->c1.c2);
  blsf2_mul(&ff_out.c1.c2, &t, &g5);
  *r = ff_out;
}

static blsf12 fpw_acc, fpw_base;

static void blsf12_pow_w(blsf12 *r, const blsf12 *x, const uint32_t *e,
                      uint32_t bits) {
  uint32_t i;
  blsf12_one(&fpw_acc);
  fpw_base = *x;
  for (i = 0; i < bits; i++) {
    if ((e[i >> 5] >> (i & 31)) & 1) blsf12_mul(&fpw_acc, &fpw_acc, &fpw_base);
    if (i + 1 < bits) blsf12_sq(&fpw_base, &fpw_base);
  }
  *r = fpw_acc;
}

/* -- curve points -------------------------------------------------------- */

typedef struct { blsfp x, y; uint32_t inf; } blsg1pt;
typedef struct { blsf2 x, y; uint32_t inf; } blsg2pt;

static uint32_t blsg1_on_curve(const blsg1pt *p) {
  blsfp l, rr, t;
  if (p->inf) return 1;
  blsfp_mul(&l, &p->y, &p->y);
  blsfp_mul(&t, &p->x, &p->x);
  blsfp_mul(&rr, &t, &p->x);
  blsfp four;
  memset(&four, 0, sizeof four);
  four.w[0] = 4;
  blsfp_add(&rr, &rr, &four);
  return blsfp_eq(&l, &rr);
}

/* Jacobian G1 (X, Y, Z): x = X/Z^2, y = Y/Z^3 */
typedef struct { blsfp x, y, z; } blsg1j;

static void blsg1j_from_affine(blsg1j *r, const blsg1pt *p) {
  r->x = p->x;
  r->y = p->y;
  memset(&r->z, 0, sizeof r->z);
  if (!p->inf) r->z.w[0] = 1;
}

static void blsg1j_double(blsg1j *r, const blsg1j *p) {
  blsfp a, b, c, d, e, f, t;
  if (blsfp_is_zero(&p->z)) { *r = *p; return; }
  blsfp_mul(&a, &p->x, &p->x);            /* A = X^2 */
  blsfp_mul(&b, &p->y, &p->y);            /* B = Y^2 */
  blsfp_mul(&c, &b, &b);                  /* C = B^2 */
  blsfp_add(&d, &p->x, &b);
  blsfp_mul(&d, &d, &d);
  blsfp_sub(&d, &d, &a);
  blsfp_sub(&d, &d, &c);
  blsfp_add(&d, &d, &d);                  /* D = 2((X+B)^2 - A - C) */
  blsfp_add(&e, &a, &a);
  blsfp_add(&e, &e, &a);                  /* E = 3A */
  blsfp_mul(&f, &e, &e);                  /* F = E^2 */
  blsg1j out;
  blsfp_sub(&out.x, &f, &d);
  blsfp_sub(&out.x, &out.x, &d);          /* X' = F - 2D */
  blsfp_sub(&t, &d, &out.x);
  blsfp_mul(&t, &e, &t);
  blsfp c8;
  blsfp_add(&c8, &c, &c);
  blsfp_add(&c8, &c8, &c8);
  blsfp_add(&c8, &c8, &c8);               /* 8C */
  blsfp_sub(&out.y, &t, &c8);             /* Y' = E(D - X') - 8C */
  blsfp_mul(&t, &p->y, &p->z);
  blsfp_add(&out.z, &t, &t);              /* Z' = 2YZ */
  *r = out;
}

static void blsg1j_add_affine(blsg1j *r, const blsg1j *p, const blsg1pt *q) {
  blsfp z2, u2, s2, h, hh, i, j, rr, v, t;
  if (q->inf) { *r = *p; return; }
  if (blsfp_is_zero(&p->z)) {
    blsg1j_from_affine(r, q);
    return;
  }
  blsfp_mul(&z2, &p->z, &p->z);
  blsfp_mul(&u2, &q->x, &z2);             /* U2 = x2 Z1^2 */
  blsfp_mul(&t, &q->y, &p->z);
  blsfp_mul(&s2, &t, &z2);                /* S2 = y2 Z1^3 */
  if (blsfp_eq(&u2, &p->x) && blsfp_eq(&s2, &p->y)) {
    blsg1j_double(r, p);
    return;
  }
  blsfp_sub(&h, &u2, &p->x);              /* H = U2 - X1 */
  blsfp_mul(&hh, &h, &h);
  blsfp_add(&i, &hh, &hh);
  blsfp_add(&i, &i, &i);                  /* I = 4 HH */
  blsfp_mul(&j, &h, &i);                  /* J = H I */
  blsfp_sub(&rr, &s2, &p->y);
  blsfp_add(&rr, &rr, &rr);               /* r = 2(S2 - Y1) */
  blsfp_mul(&v, &p->x, &i);               /* V = X1 I */
  blsg1j out;
  blsfp_mul(&out.x, &rr, &rr);
  blsfp_sub(&out.x, &out.x, &j);
  blsfp_sub(&out.x, &out.x, &v);
  blsfp_sub(&out.x, &out.x, &v);          /* X3 = r^2 - J - 2V */
  blsfp_sub(&t, &v, &out.x);
  blsfp_mul(&t, &rr, &t);
  blsfp y1j;
  blsfp_mul(&y1j, &p->y, &j);
  blsfp_add(&y1j, &y1j, &y1j);
  blsfp_sub(&out.y, &t, &y1j);            /* Y3 = r(V - X3) - 2 Y1 J */
  blsfp_add(&t, &p->z, &h);
  blsfp_mul(&t, &t, &t);
  blsfp_sub(&t, &t, &z2);
  blsfp_sub(&out.z, &t, &hh);             /* Z3 = (Z1+H)^2 - Z1^2 - HH */
  *r = out;
}

/* scalar multiply (scalar as 12 LE limbs, up to 384 bits) */
static void blsg1_mul_w(blsg1pt *r, const blsg1pt *p, const uint32_t *k,
                     uint32_t bits) {
  blsg1j acc;
  uint32_t i;
  memset(&acc, 0, sizeof acc);         /* Z = 0: infinity */
  acc.x.w[0] = 1;
  acc.y.w[0] = 1;
  for (i = bits; i-- > 0;) {
    blsg1j_double(&acc, &acc);
    if ((k[i >> 5] >> (i & 31)) & 1) blsg1j_add_affine(&acc, &acc, p);
  }
  if (blsfp_is_zero(&acc.z)) { r->inf = 1; return; }
  blsfp zi, zi2, zi3;
  blsfp_inv(&zi, &acc.z);
  blsfp_mul(&zi2, &zi, &zi);
  blsfp_mul(&zi3, &zi2, &zi);
  blsfp_mul(&r->x, &acc.x, &zi2);
  blsfp_mul(&r->y, &acc.y, &zi3);
  r->inf = 0;
}

static uint32_t blsg1_in_subgroup(const blsg1pt *p) {
  blsg1pt t;
  if (p->inf) return 1;
  blsg1_mul_w(&t, p, BLS_R_W, 255);
  return t.inf;
}

static void blsg1_neg(blsg1pt *r, const blsg1pt *p) {
  *r = *p;
  if (!p->inf) blsfp_neg(&r->y, &p->y);
}

/* affine G1 add (used once; slow path is fine) */
static void blsg1_add(blsg1pt *r, const blsg1pt *p, const blsg1pt *q) {
  blsfp s, t, d, x3;
  if (p->inf) { *r = *q; return; }
  if (q->inf) { *r = *p; return; }
  if (blsfp_eq(&p->x, &q->x)) {
    blsfp ny;
    blsfp_neg(&ny, &q->y);
    if (blsfp_eq(&p->y, &ny)) { memset(r, 0, sizeof *r); r->inf = 1; return; }
    blsfp_mul(&t, &p->x, &p->x);
    blsfp_add(&s, &t, &t);
    blsfp_add(&s, &s, &t);                /* 3x^2 */
    blsfp_add(&d, &p->y, &p->y);
    blsfp_inv(&d, &d);
    blsfp_mul(&s, &s, &d);
  } else {
    blsfp_sub(&s, &q->y, &p->y);
    blsfp_sub(&d, &q->x, &p->x);
    blsfp_inv(&d, &d);
    blsfp_mul(&s, &s, &d);
  }
  blsfp_mul(&x3, &s, &s);
  blsfp_sub(&x3, &x3, &p->x);
  blsfp_sub(&x3, &x3, &q->x);
  blsfp_sub(&t, &p->x, &x3);
  blsfp_mul(&t, &s, &t);
  blsfp_sub(&r->y, &t, &p->y);
  r->x = x3;
  r->inf = 0;
}

/* G2 affine ops (Miller loop) */
static void blsg2_add(blsg2pt *r, const blsg2pt *p, const blsg2pt *q) {
  blsf2 s, t, d, x3;
  if (p->inf) { *r = *q; return; }
  if (q->inf) { *r = *p; return; }
  if (blsf2_eq(&p->x, &q->x)) {
    blsf2 ny;
    blsf2_neg(&ny, &q->y);
    if (blsf2_eq(&p->y, &ny)) { memset(r, 0, sizeof *r); r->inf = 1; return; }
    blsf2_mul(&t, &p->x, &p->x);
    blsf2_add(&s, &t, &t);
    blsf2_add(&s, &s, &t);
    blsf2_add(&d, &p->y, &p->y);
    blsf2_inv(&d, &d);
    blsf2_mul(&s, &s, &d);
  } else {
    blsf2_sub(&s, &q->y, &p->y);
    blsf2_sub(&d, &q->x, &p->x);
    blsf2_inv(&d, &d);
    blsf2_mul(&s, &s, &d);
  }
  blsf2_mul(&x3, &s, &s);
  blsf2_sub(&x3, &x3, &p->x);
  blsf2_sub(&x3, &x3, &q->x);
  blsf2_sub(&t, &p->x, &x3);
  blsf2_mul(&t, &s, &t);
  blsf2_sub(&r->y, &t, &p->y);
  r->x = x3;
  r->inf = 0;
}

/* Jacobian G2 scalar multiply (for [z] G2 with no per-step inversions) */
typedef struct { blsf2 x, y, z; } blsg2j;

static void blsg2j_double(blsg2j *r, const blsg2j *p) {
  blsf2 a, b, c, d, e, f, t, c8;
  if (blsf2_is_zero(&p->z)) { *r = *p; return; }
  blsf2_mul(&a, &p->x, &p->x);
  blsf2_mul(&b, &p->y, &p->y);
  blsf2_mul(&c, &b, &b);
  blsf2_add(&d, &p->x, &b);
  blsf2_mul(&d, &d, &d);
  blsf2_sub(&d, &d, &a);
  blsf2_sub(&d, &d, &c);
  blsf2_add(&d, &d, &d);
  blsf2_add(&e, &a, &a);
  blsf2_add(&e, &e, &a);
  blsf2_mul(&f, &e, &e);
  blsg2j out;
  blsf2_sub(&out.x, &f, &d);
  blsf2_sub(&out.x, &out.x, &d);
  blsf2_sub(&t, &d, &out.x);
  blsf2_mul(&t, &e, &t);
  blsf2_add(&c8, &c, &c);
  blsf2_add(&c8, &c8, &c8);
  blsf2_add(&c8, &c8, &c8);
  blsf2_sub(&out.y, &t, &c8);
  blsf2_mul(&t, &p->y, &p->z);
  blsf2_add(&out.z, &t, &t);
  *r = out;
}

static void blsg2j_add_affine(blsg2j *r, const blsg2j *p, const blsg2pt *q) {
  blsf2 z2, u2, s2, h, hh, i, j, rr, v, t, y1j;
  if (q->inf) { *r = *p; return; }
  if (blsf2_is_zero(&p->z)) {
    r->x = q->x;
    r->y = q->y;
    blsf2_zero(&r->z);
    r->z.a.w[0] = 1;
    return;
  }
  blsf2_mul(&z2, &p->z, &p->z);
  blsf2_mul(&u2, &q->x, &z2);
  blsf2_mul(&t, &q->y, &p->z);
  blsf2_mul(&s2, &t, &z2);
  if (blsf2_eq(&u2, &p->x) && blsf2_eq(&s2, &p->y)) {
    blsg2j_double(r, p);
    return;
  }
  blsf2_sub(&h, &u2, &p->x);
  blsf2_mul(&hh, &h, &h);
  blsf2_add(&i, &hh, &hh);
  blsf2_add(&i, &i, &i);
  blsf2_mul(&j, &h, &i);
  blsf2_sub(&rr, &s2, &p->y);
  blsf2_add(&rr, &rr, &rr);
  blsf2_mul(&v, &p->x, &i);
  blsg2j out;
  blsf2_mul(&out.x, &rr, &rr);
  blsf2_sub(&out.x, &out.x, &j);
  blsf2_sub(&out.x, &out.x, &v);
  blsf2_sub(&out.x, &out.x, &v);
  blsf2_sub(&t, &v, &out.x);
  blsf2_mul(&t, &rr, &t);
  blsf2_mul(&y1j, &p->y, &j);
  blsf2_add(&y1j, &y1j, &y1j);
  blsf2_sub(&out.y, &t, &y1j);
  blsf2_add(&t, &p->z, &h);
  blsf2_mul(&t, &t, &t);
  blsf2_sub(&t, &t, &z2);
  blsf2_sub(&out.z, &t, &hh);
  *r = out;
}

static void blsg2_mul_w(blsg2pt *r, const blsg2pt *p, const uint32_t *k,
                     uint32_t bits) {
  blsg2j acc;
  uint32_t i;
  blsf2_zero(&acc.x);
  blsf2_zero(&acc.y);
  blsf2_zero(&acc.z);
  acc.x.a.w[0] = 1;
  acc.y.a.w[0] = 1;
  for (i = bits; i-- > 0;) {
    blsg2j_double(&acc, &acc);
    if ((k[i >> 5] >> (i & 31)) & 1) blsg2j_add_affine(&acc, &acc, p);
  }
  if (blsf2_is_zero(&acc.z)) { memset(r, 0, sizeof *r); r->inf = 1; return; }
  blsf2 zi, zi2, zi3;
  blsf2_inv(&zi, &acc.z);
  blsf2_mul(&zi2, &zi, &zi);
  blsf2_mul(&zi3, &zi2, &zi);
  blsf2_mul(&r->x, &acc.x, &zi2);
  blsf2_mul(&r->y, &acc.y, &zi3);
  r->inf = 0;
}

static void blsg2_neg(blsg2pt *r, const blsg2pt *p) {
  *r = *p;
  if (!p->inf) blsf2_neg(&r->y, &p->y);
}

/* -- ate pairing --------------------------------------------------------- */

/* Line through q1, q2 evaluated at p, scaled by XI (killed by the final
 * exponentiation): XI*l = (XI*py, 0, 0) + (0, s x1 - y1, -s px) w; a
 * vertical line gives (XI*px, 0, -x1) + 0 w (app/bls12381.py _line). */
static void bls_line_eval(blsf12 *out, const blsg2pt *q1, const blsg2pt *q2,
                      const blsg1pt *p) {
  blsf2 s, t, d;
  memset(out, 0, sizeof *out);
  if (blsf2_eq(&q1->x, &q2->x) && blsf2_eq(&q1->y, &q2->y)) {
    blsf2_mul(&t, &q1->x, &q1->x);
    blsf2_add(&s, &t, &t);
    blsf2_add(&s, &s, &t);
    blsf2_add(&d, &q1->y, &q1->y);
    blsf2_inv(&d, &d);
    blsf2_mul(&s, &s, &d);
  } else if (blsf2_eq(&q1->x, &q2->x)) {
    /* vertical */
    blsf2 xi_px;
    memset(&xi_px, 0, sizeof xi_px);
    xi_px.a = p->x;
    xi_px.b = p->x;                     /* XI * px = px + px u */
    out->c0.c0 = xi_px;
    blsf2_neg(&out->c0.c2, &q1->x);
    return;
  } else {
    blsf2_sub(&s, &q2->y, &q1->y);
    blsf2_sub(&d, &q2->x, &q1->x);
    blsf2_inv(&d, &d);
    blsf2_mul(&s, &s, &d);
  }
  /* XI*py into c0.c0 */
  out->c0.c0.a = p->y;
  out->c0.c0.b = p->y;
  /* b = s x1 - y1 into c1.c1 */
  blsf2_mul(&t, &s, &q1->x);
  blsf2_sub(&out->c1.c1, &t, &q1->y);
  /* c = -s px into c1.c2 */
  blsfp npx;
  blsfp_neg(&npx, &p->x);
  blsf2_mul_fp(&out->c1.c2, &s, &npx);
}

static blsf12 ml_l, ml_nf;
static blsg2pt ml_t;

static void bls_miller_loop(blsf12 *f, const blsg2pt *q, const blsg1pt *p) {
  uint32_t i;
  blsf12_one(f);
  if (q->inf || p->inf) return;
  ml_t = *q;
  for (i = 0; i < 63; i++) {
    blsf12_sq(&ml_nf, f);
    bls_line_eval(&ml_l, &ml_t, &ml_t, p);
    blsf12_mul(f, &ml_nf, &ml_l);
    blsg2_add(&ml_t, &ml_t, &ml_t);
    if (BLS_X_BITS[i]) {
      bls_line_eval(&ml_l, &ml_t, q, p);
      blsf12_mul(f, f, &ml_l);
      blsg2_add(&ml_t, &ml_t, q);
    }
  }
  /* x < 0: conjugate (= inverse after the final exponentiation) */
  blsf12_conj(f, f);
}

static blsf12 fe_f1, fe_fi, fe_t, fe_u;

static void bls_final_exp(blsf12 *r, const blsf12 *f) {
  blsf12_conj(&fe_f1, f);
  blsf12_inv(&fe_fi, f);
  blsf12_mul(&fe_t, &fe_f1, &fe_fi);      /* f^(p^6 - 1) */
  blsf12_frob(&fe_u, &fe_t);
  blsf12_frob(&fe_u, &fe_u);
  blsf12_mul(&fe_t, &fe_u, &fe_t);        /* ^(p^2 + 1) */
  blsf12_pow_w(r, &fe_t, BLS_HARD_EXP_W, BLS_HARD_EXP_BITS);
}

/* -- decompression + KZG -------------------------------------------------- */

static int blsg1_decompress(blsg1pt *out, const uint8_t *data) {
  uint32_t c_flag = (data[0] >> 7) & 1;
  uint32_t i_flag = (data[0] >> 6) & 1;
  uint32_t s_flag = (data[0] >> 5) & 1;
  uint8_t buf[48];
  blsfp x, rhs, y, t, ny;
  if (!c_flag) return -1;
  memcpy(buf, data, 48);
  buf[0] &= 0x1F;
  blsfp_from_be48(&x, buf);
  if (i_flag) {
    uint32_t i, acc = 0;
    for (i = 0; i < 12; i++) acc |= x.w[i];
    if (acc || s_flag) return -1;
    memset(out, 0, sizeof *out);
    out->inf = 1;
    return 0;
  }
  if (blsfp_cmp(&x, &BLS_FP_P) >= 0) return -1;
  blsfp_mul(&t, &x, &x);
  blsfp_mul(&rhs, &t, &x);
  blsfp four;
  memset(&four, 0, sizeof four);
  four.w[0] = 4;
  blsfp_add(&rhs, &rhs, &four);
  if (!blsfp_sqrt(&y, &rhs)) return -1;
  /* s_flag = lexicographically larger root */
  blsfp_neg(&ny, &y);
  if ((blsfp_cmp(&y, &ny) > 0) != (s_flag != 0)) y = ny;
  out->x = x;
  out->y = y;
  out->inf = 0;
  if (!blsg1_in_subgroup(out)) return -1;
  return 0;
}

static blsg1pt kv_c, kv_w, kv_yg, kv_cmy, kv_g1;
static blsg2pt kv_x2, kv_zg2, kv_xmz, kv_ng2, kv_g2;
static blsf12 kv_f, kv_l, kv_acc;

int bls_kzg_verify(const uint8_t commitment[48], const uint8_t z_be[32],
                   const uint8_t y_be[32], const uint8_t proof[48],
                   const uint32_t setup_g2[48]) {
  blsfp z, y;
  uint32_t zw[12], yw[12], i;

  blsfp_from_w(&BLS_FP_P, BLS_P_W);

  if (blsg1_decompress(&kv_c, commitment) < 0) return -1;
  if (blsg1_decompress(&kv_w, proof) < 0) return -1;

  /* z, y < r (32-byte big-endian scalars) */
  memset(&z, 0, sizeof z);
  memset(&y, 0, sizeof y);
  for (i = 0; i < 8; i++) {
    const uint8_t *pz = z_be + 28 - 4 * i;
    const uint8_t *py = y_be + 28 - 4 * i;
    z.w[i] = ((uint32_t)pz[0] << 24) | ((uint32_t)pz[1] << 16) |
             ((uint32_t)pz[2] << 8) | pz[3];
    y.w[i] = ((uint32_t)py[0] << 24) | ((uint32_t)py[1] << 16) |
             ((uint32_t)py[2] << 8) | py[3];
  }
  {
    blsfp rmod;
    blsfp_from_w(&rmod, BLS_R_W);
    if (blsfp_cmp(&z, &rmod) >= 0 || blsfp_cmp(&y, &rmod) >= 0) return -1;
  }
  memcpy(zw, z.w, 48);
  memcpy(yw, y.w, 48);

  /* generators + setup */
  blsfp_from_w(&kv_g1.x, BLSG1X_W);
  blsfp_from_w(&kv_g1.y, BLSG1Y_W);
  kv_g1.inf = 0;
  blsfp_from_w(&kv_g2.x.a, BLSG2X0_W);
  blsfp_from_w(&kv_g2.x.b, BLSG2X1_W);
  blsfp_from_w(&kv_g2.y.a, BLSG2Y0_W);
  blsfp_from_w(&kv_g2.y.b, BLSG2Y1_W);
  kv_g2.inf = 0;
  blsfp_from_w(&kv_x2.x.a, setup_g2);
  blsfp_from_w(&kv_x2.x.b, setup_g2 + 12);
  blsfp_from_w(&kv_x2.y.a, setup_g2 + 24);
  blsfp_from_w(&kv_x2.y.b, setup_g2 + 36);
  kv_x2.inf = 0;

  /* C - [y]_1 and [tau - z]_2 */
  blsg1_mul_w(&kv_yg, &kv_g1, yw, 256);
  blsg1_neg(&kv_yg, &kv_yg);
  blsg1_add(&kv_cmy, &kv_c, &kv_yg);
  blsg2_mul_w(&kv_zg2, &kv_g2, zw, 256);
  blsg2_neg(&kv_zg2, &kv_zg2);
  blsg2_add(&kv_xmz, &kv_x2, &kv_zg2);

  /* e(C - y G1, -G2) * e(W, X - z G2) == 1 */
  blsg2_neg(&kv_ng2, &kv_g2);
  if (kv_cmy.inf && kv_w.inf) return 1;
  bls_miller_loop(&kv_f, &kv_ng2, &kv_cmy);
  bls_miller_loop(&kv_l, &kv_xmz, &kv_w);
  blsf12_mul(&kv_f, &kv_f, &kv_l);
  bls_final_exp(&kv_acc, &kv_f);
  return blsf12_is_one(&kv_acc) ? 1 : 0;
}

/* -- EIP-2537 precompile backend (Prague, addresses 0x0b..0x0f) ----------
 *
 * Mirrors the host dispatch (app/bls12381.py eip2537_dispatch): Fp is 64
 * bytes (16 zero bytes || 48-byte BE), G1 = 128, G2 = 256, infinity =
 * all-zero. ADD accepts any on-curve point; MSM/PAIRING require
 * subgroup membership. Gas discount tables mirror app/csrc/evm.cpp. */

static const uint16_t BLS_G1_DISC[128] = {
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

static const uint16_t BLS_G2_DISC[128] = {
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

uint32_t bls_msm_gas(uint32_t k, uint32_t base, uint32_t g2) {
  uint32_t idx, disc, m, q, r;
  if (k == 0) return 0;
  idx = (k < 128 ? k : 128) - 1;
  disc = g2 ? BLS_G2_DISC[idx] : BLS_G1_DISC[idx];
  /* exact uint32 mirror of the host's u64 k*base*disc/1000: with
   * m = base*disc (<= 2.25e7), k*m/1000 == k*(m/1000) + k*(m%1000)/1000
   * (the first term's product is a multiple of 1000). k*(m/1000)
   * overflows only for k >= ~190k where the true gas already exceeds
   * any block limit — saturate (both sides then fail the charge). */
  m = base * disc;
  q = m / 1000u;
  r = m % 1000u;
  if (k >= 190000u) return 0xFFFFFFFFu;
  return k * q + (k * r) / 1000u;
}

static int bls_dec_fp64(const uint8_t *p, blsfp *out) {
  uint32_t i;
  for (i = 0; i < 16; i++)
    if (p[i]) return -1;
  blsfp_from_be48(out, p + 16);
  if (blsfp_cmp(out, &BLS_FP_P) >= 0) return -1;
  return 0;
}

static void bls_enc_fp64(const blsfp *v, uint8_t *out) {
  uint32_t i;
  memset(out, 0, 16);
  for (i = 0; i < 12; i++) {
    uint32_t w = v->w[11 - i];
    out[16 + 4 * i] = (uint8_t)(w >> 24);
    out[17 + 4 * i] = (uint8_t)(w >> 16);
    out[18 + 4 * i] = (uint8_t)(w >> 8);
    out[19 + 4 * i] = (uint8_t)w;
  }
}

static int bls_g1_on_curve(const blsg1pt *p) {
  blsfp t, rhs, four;
  if (p->inf) return 1;
  blsfp_mul(&t, &p->x, &p->x);
  blsfp_mul(&rhs, &t, &p->x);
  memset(&four, 0, sizeof four);
  four.w[0] = 4;
  blsfp_add(&rhs, &rhs, &four);
  blsfp_mul(&t, &p->y, &p->y);
  return blsfp_eq(&t, &rhs);
}

static int bls_g2_on_curve(const blsg2pt *p) {
  blsf2 t, rhs, b2;
  if (p->inf) return 1;
  blsf2_mul(&t, &p->x, &p->x);
  blsf2_mul(&rhs, &t, &p->x);
  memset(&b2, 0, sizeof b2);            /* B2 = 4 (1 + u) */
  b2.a.w[0] = 4;
  b2.b.w[0] = 4;
  blsf2_add(&rhs, &rhs, &b2);
  blsf2_mul(&t, &p->y, &p->y);
  return blsf2_eq(&t, &rhs);
}

static uint32_t blsg2_in_subgroup(const blsg2pt *p) {
  blsg2pt t;
  if (p->inf) return 1;
  blsg2_mul_w(&t, p, BLS_R_W, 255);
  return t.inf;
}

static int bls_dec_g1_128(const uint8_t *p, blsg1pt *out, int sub) {
  uint32_t i, zero = 1;
  for (i = 0; i < 128; i++)
    if (p[i]) { zero = 0; break; }
  if (zero) {
    memset(out, 0, sizeof *out);
    out->inf = 1;
    return 0;
  }
  if (bls_dec_fp64(p, &out->x) < 0) return -1;
  if (bls_dec_fp64(p + 64, &out->y) < 0) return -1;
  out->inf = 0;
  if (!bls_g1_on_curve(out)) return -1;
  if (sub && !blsg1_in_subgroup(out)) return -1;
  return 0;
}

static void bls_enc_g1_128(const blsg1pt *p, uint8_t *out) {
  if (p->inf) {
    memset(out, 0, 128);
    return;
  }
  bls_enc_fp64(&p->x, out);
  bls_enc_fp64(&p->y, out + 64);
}

static int bls_dec_g2_256(const uint8_t *p, blsg2pt *out, int sub) {
  uint32_t i, zero = 1;
  for (i = 0; i < 256; i++)
    if (p[i]) { zero = 0; break; }
  if (zero) {
    memset(out, 0, sizeof *out);
    out->inf = 1;
    return 0;
  }
  if (bls_dec_fp64(p, &out->x.a) < 0) return -1;
  if (bls_dec_fp64(p + 64, &out->x.b) < 0) return -1;
  if (bls_dec_fp64(p + 128, &out->y.a) < 0) return -1;
  if (bls_dec_fp64(p + 192, &out->y.b) < 0) return -1;
  out->inf = 0;
  if (!bls_g2_on_curve(out)) return -1;
  if (sub && !blsg2_in_subgroup(out)) return -1;
  return 0;
}

static void bls_enc_g2_256(const blsg2pt *p, uint8_t *out) {
  if (p->inf) {
    memset(out, 0, 256);
    return;
  }
  bls_enc_fp64(&p->x.a, out);
  bls_enc_fp64(&p->x.b, out + 64);
  bls_enc_fp64(&p->y.a, out + 128);
  bls_enc_fp64(&p->y.b, out + 192);
}

static void bls_scalar_w(const uint8_t *be32, uint32_t w[12]) {
  uint32_t i;
  memset(w, 0, 48);
  for (i = 0; i < 8; i++) {
    const uint8_t *p = be32 + 28 - 4 * i;
    w[i] = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | p[3];
  }
}

static blsg1pt ep_a1, ep_b1, ep_acc1;
static blsg2pt ep_a2, ep_b2, ep_acc2;
static blsf12 ep_f, ep_m;

int bls_eip2537(int op, const uint8_t *input, uint32_t len, uint8_t *out,
                uint32_t *outlen) {
  uint32_t off;
  blsfp_from_w(&BLS_FP_P, BLS_P_W);
  switch (op) {
    case 0:                                               /* g1 add */
      if (len != 256) return 0;
      if (bls_dec_g1_128(input, &ep_a1, 0) < 0) return 0;
      if (bls_dec_g1_128(input + 128, &ep_b1, 0) < 0) return 0;
      blsg1_add(&ep_acc1, &ep_a1, &ep_b1);
      bls_enc_g1_128(&ep_acc1, out);
      *outlen = 128;
      return 1;
    case 1: {                                             /* g1 msm */
      uint32_t kw[12];
      if (len == 0 || len % 160) return 0;
      memset(&ep_acc1, 0, sizeof ep_acc1);
      ep_acc1.inf = 1;
      for (off = 0; off < len; off += 160) {
        if (bls_dec_g1_128(input + off, &ep_a1, 1) < 0) return 0;
        bls_scalar_w(input + off + 128, kw);
        blsg1_mul_w(&ep_b1, &ep_a1, kw, 256);
        blsg1_add(&ep_acc1, &ep_acc1, &ep_b1);
      }
      bls_enc_g1_128(&ep_acc1, out);
      *outlen = 128;
      return 1;
    }
    case 2:                                               /* g2 add */
      if (len != 512) return 0;
      if (bls_dec_g2_256(input, &ep_a2, 0) < 0) return 0;
      if (bls_dec_g2_256(input + 256, &ep_b2, 0) < 0) return 0;
      blsg2_add(&ep_acc2, &ep_a2, &ep_b2);
      bls_enc_g2_256(&ep_acc2, out);
      *outlen = 256;
      return 1;
    case 3: {                                             /* g2 msm */
      uint32_t kw[12];
      if (len == 0 || len % 288) return 0;
      memset(&ep_acc2, 0, sizeof ep_acc2);
      ep_acc2.inf = 1;
      for (off = 0; off < len; off += 288) {
        if (bls_dec_g2_256(input + off, &ep_a2, 1) < 0) return 0;
        bls_scalar_w(input + off + 256, kw);
        blsg2_mul_w(&ep_b2, &ep_a2, kw, 256);
        blsg2_add(&ep_acc2, &ep_acc2, &ep_b2);
      }
      bls_enc_g2_256(&ep_acc2, out);
      *outlen = 256;
      return 1;
    }
    case 4: {                                             /* pairing */
      uint32_t any = 0;
      if (len == 0 || len % 384) return 0;
      blsf12_one(&ep_f);
      for (off = 0; off < len; off += 384) {
        if (bls_dec_g1_128(input + off, &ep_a1, 1) < 0) return 0;
        if (bls_dec_g2_256(input + off + 128, &ep_a2, 1) < 0) return 0;
        if (ep_a1.inf || ep_a2.inf) continue;
        bls_miller_loop(&ep_m, &ep_a2, &ep_a1);
        blsf12_mul(&ep_f, &ep_f, &ep_m);
        any = 1;
      }
      memset(out, 0, 32);
      if (!any) {
        out[31] = 1;
      } else {
        bls_final_exp(&ep_f, &ep_f);
        out[31] = blsf12_is_one(&ep_f) ? 1 : 0;
      }
      *outlen = 32;
      return 1;
    }
  }
  return 0;
}
