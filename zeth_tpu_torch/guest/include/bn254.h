#ifndef _G_BN254_H
#define _G_BN254_H
#include <stdint.h>

/* alt_bn128 optimal ate pairing check (EVM precompile 0x08 semantics,
 * mirroring the host engine's zeth_tpu/app/bn254.py):
 *   input = k * 192 bytes (G1 x,y | G2 x_im,x_re,y_im,y_re, big-endian)
 *   returns 1 (product of pairings == 1), 0 (valid input, != 1),
 *   -1 (invalid input: coordinate >= p, point off-curve, or G2 point
 *       outside the order-r subgroup).
 * All 256-bit modular multiplies run on the SYS_BIGINT accelerator. */
int bn254_pairing_check(const uint8_t *input, uint32_t len);

#endif
