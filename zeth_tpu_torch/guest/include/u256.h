#ifndef _G_U256_H
#define _G_U256_H
#include <stdint.h>

/* 256-bit unsigned integers as 8 little-endian 32-bit limbs (the guest
 * target has no 64-bit ints; products use the __mulhu builtin). */
typedef struct { uint32_t w[8]; } u256;

extern uint32_t __mulhu(uint32_t a, uint32_t b);
/* compiler builtins: unrolled 8-limb carry chains / compare */
extern uint32_t __u256_add(uint32_t *r, const uint32_t *a, const uint32_t *b);
extern uint32_t __u256_sub(uint32_t *r, const uint32_t *a, const uint32_t *b);
extern uint32_t __u256_lt(const uint32_t *a, const uint32_t *b);

void u256_zero(u256 *r);
void u256_from_u32(u256 *r, uint32_t v);
uint32_t u256_is_zero(const u256 *a);
int u256_cmp(const u256 *a, const u256 *b);
uint32_t u256_eq(const u256 *a, const u256 *b);
uint32_t u256_add(u256 *r, const u256 *a, const u256 *b);   /* -> carry */
uint32_t u256_sub(u256 *r, const u256 *a, const u256 *b);   /* -> borrow */
void u256_mul(u256 *r, const u256 *a, const u256 *b);       /* mod 2^256 */
void u256_div(u256 *q, const u256 *a, const u256 *b);       /* b=0 -> 0 */
void u256_mod(u256 *r, const u256 *a, const u256 *b);       /* b=0 -> 0 */
void u256_sdiv(u256 *q, const u256 *a, const u256 *b);
void u256_smod(u256 *r, const u256 *a, const u256 *b);
void u256_addmod(u256 *r, const u256 *a, const u256 *b, const u256 *m);
void u256_mulmod(u256 *r, const u256 *a, const u256 *b, const u256 *m);
void u256_exp(u256 *r, const u256 *a, const u256 *e);       /* mod 2^256 */
void u256_shl(u256 *r, const u256 *a, uint32_t sh);
void u256_shr(u256 *r, const u256 *a, uint32_t sh);
void u256_sar(u256 *r, const u256 *a, uint32_t sh);
void u256_not(u256 *r, const u256 *a);
void u256_neg(u256 *r, const u256 *a);
int u256_scmp(const u256 *a, const u256 *b);
uint32_t u256_bitlen(const u256 *a);
uint32_t u256_bit(const u256 *a, uint32_t i);

/* big-endian 32-byte (EVM word) conversions */
void u256_from_be(u256 *r, const uint8_t be[32]);
void u256_to_be(const u256 *a, uint8_t be[32]);
/* big-endian minimal/partial buffers (RLP quantities) */
void u256_from_be_n(u256 *r, const uint8_t *be, uint32_t n);
uint32_t u256_to_be_min(const u256 *a, uint8_t out[32]);  /* -> n bytes */
uint32_t u256_fits_u32(const u256 *a);
uint32_t u256_low_u32(const u256 *a);

/* modular reduction via the bigint accelerator: r = a mod m (m != 0) */
void u256_redc(u256 *r, const u256 *a, const u256 *m);
/* r = (a mod m) * (b mod m) mod m via the accelerator (m != 0) */
void u256_modmul(u256 *r, const u256 *a, const u256 *b, const u256 *m);
/* single-syscall modmul; REQUIRES a*b < m*2^256 (e.g. a < m or b < m) */
void u256_modmul_raw(u256 *r, const u256 *a, const u256 *b, const u256 *m);

#endif
