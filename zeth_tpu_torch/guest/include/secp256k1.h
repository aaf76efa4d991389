#ifndef _G_SECP_H
#define _G_SECP_H
#include <stdint.h>
#include <u256.h>

/* ECDSA public-key recovery (the ecrecover precompile and transaction
 * sender recovery). Returns 1 and writes the 20-byte address on
 * success, 0 on invalid signature. recid in {0, 1} (v - 27); r/s/hash
 * big-endian 32-byte. */
uint32_t secp_ecrecover(const uint8_t hash[32], uint32_t recid,
                        const u256 *r, const u256 *s, uint8_t out_addr[20]);

#endif
