#ifndef _G_HASHES_H
#define _G_HASHES_H
#include <stdint.h>
/* sha-256 over arbitrary input via the SYS_SHA256 compression syscall */
void sha256(const uint8_t *data, uint32_t len, uint8_t out[32]);
/* ripemd-160 (precompile 0x03), pure 32-bit C */
void ripemd160(const uint8_t *data, uint32_t len, uint8_t out[20]);
/* blake2f compression (precompile 0x09): io layout matches the EVM
 * input [rounds(4BE) h(64) m(128) t(16) final(1)]; writes h back */
void blake2f(uint32_t rounds, uint8_t h[64], const uint8_t m[128],
             const uint8_t t[16], uint32_t final_flag);
#endif
