/* BLS12-381 for the EIP-4844 KZG point-evaluation precompile (0x0a).
 *
 * Guest-side mirror of the host engine's zeth_tpu/app/bls12381.py +
 * app/kzg.py. All 381-bit modular multiplies run on the (384-bit wide)
 * SYS_BIGINT accelerator. */
#ifndef ZETH_BLS381_H
#define ZETH_BLS381_H

#include <stdint.h>

/* verify_kzg_proof(commitment, z, y, proof) against the provisioned
 * [tau]_2 setup point (4 x 12 little-endian u32 limbs: x.c0 x.c1 y.c0
 * y.c1). z/y are 32-byte big-endian scalars. Returns 1 (valid),
 * 0 (invalid proof), -1 (malformed input: bad point encoding, scalar
 * out of range). */
int bls_kzg_verify(const uint8_t commitment[48], const uint8_t z_be[32],
                   const uint8_t y_be[32], const uint8_t proof[48],
                   const uint32_t setup_g2[48]);

/* EIP-2537 precompile backend (Prague): op 0=g1add 1=g1msm 2=g2add
 * 3=g2msm 4=pairing. out cap 256. Returns 1 ok, 0 invalid input. */
int bls_eip2537(int op, const uint8_t *input, uint32_t len, uint8_t *out,
                uint32_t *outlen);
/* gas for an EIP-2537 MSM: k terms, per-term base, g2 selects the table */
uint32_t bls_msm_gas(uint32_t k, uint32_t base, uint32_t g2);

#endif
