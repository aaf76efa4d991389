/* zkVM guest ABI: syscalls + tiny runtime.
 *
 * The guest-side surface of the framework's zkVM (the role of
 * risc0_zkvm::guest::env — SURVEY.md §2.1, guest syscall API
 * guests/stateless-client/src/lib.rs:17,26,33). Syscall numbers match
 * zeth_tpu_torch/executor/csrc/rv32im.cpp (SYS_*). `__ecall(num, a0, a1)` is
 * a zeth-cc compiler builtin that places num in a7 and returns the
 * post-syscall a0.
 */
#ifndef _ZETH_H
#define _ZETH_H

#include <stdint.h>

extern uint32_t __ecall(uint32_t num, uint32_t a0, uint32_t a1);

#define SYS_HALT 0u
#define SYS_READ 1u
#define SYS_COMMIT 2u
#define SYS_LOG 3u
#define SYS_CYCLE 4u
#define SYS_KECCAK 5u
#define SYS_BIGINT 6u
#define SYS_SHA256 7u

/* read up to n bytes of host input into dst (word-aligned, n % 4 == 0);
 * returns bytes read */
static uint32_t env_read(void *dst, uint32_t n) {
  return __ecall(SYS_READ, (uint32_t)dst, n);
}

/* append n bytes at src to the journal (word-aligned, n % 4 == 0) */
static void env_commit(const void *src, uint32_t n) {
  __ecall(SYS_COMMIT, (uint32_t)src, n);
}

static void env_log(const char *msg, uint32_t n) {
  __ecall(SYS_LOG, (uint32_t)msg, n);
}

static uint32_t env_cycle(void) { return __ecall(SYS_CYCLE, 0, 0); }

/* in-place keccak-f[1600] over a 200-byte (word-aligned) state */
static void sys_keccakf(void *state) { __ecall(SYS_KECCAK, (uint32_t)state, 0); }

/* io = [a(32B) | b(32B) | m(32B) | r(32B)] little-endian; r = a*b mod m */
static void sys_bigint_modmul(void *io) { __ecall(SYS_BIGINT, (uint32_t)io, 0); }

/* io = [state(32B) | block(64B) | out(32B)]; out = sha256-compress */
static void sys_sha256_compress(void *io) { __ecall(SYS_SHA256, (uint32_t)io, 0); }

static void env_halt(uint32_t code) { __ecall(SYS_HALT, code, 0); }

#endif
