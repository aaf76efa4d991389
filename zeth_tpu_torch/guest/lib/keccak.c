/* Guest keccak-256: sponge over the SYS_KECCAK permutation syscall.
 *
 * The guest-side half of the keccak accelerator offload (SURVEY.md §2.2
 * risc0-circuit-keccak: the reference patches tiny-keccak to route
 * permutations to the host, guests/stateless-client/Cargo.toml:32-39).
 * Rate 136 bytes, Ethereum 0x01 domain padding.
 */
#include <stdint.h>
#include <string.h>
#include <zeth.h>
#include <keccak.h>

#define RATE 136u

static uint32_t kst[50];   /* 200-byte state, word-aligned for the syscall */

void keccak256(const uint8_t *data, uint32_t len, uint8_t out[32]) {
  uint8_t *st = (uint8_t *)kst;
  uint32_t i;
  memset(st, 0, 200);
  while (len >= RATE) {
    if ((((uint32_t)data) & 3) == 0) {
      uint32_t *dw = (uint32_t *)data;
      for (i = 0; i < RATE / 4; i++) kst[i] ^= dw[i];
    } else {
      for (i = 0; i < RATE; i++) st[i] ^= data[i];
    }
    sys_keccakf(kst);
    data += RATE;
    len -= RATE;
  }
  for (i = 0; i < len; i++) st[i] ^= data[i];
  st[len] ^= 0x01;
  st[RATE - 1] ^= 0x80;
  sys_keccakf(kst);
  memcpy(out, st, 32);
}
