#ifndef _G_KECCAK_H
#define _G_KECCAK_H
#include <stdint.h>
/* keccak-256 (Ethereum variant, 0x01 padding) via the SYS_KECCAK
 * accelerator syscall (one ecall per f[1600] permutation) */
void keccak256(const uint8_t *data, uint32_t len, uint8_t out[32]);
#endif
