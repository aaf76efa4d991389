#ifndef _G_EVM_H
#define _G_EVM_H
#include <stdint.h>
#include <u256.h>
#include <gstate.h>

/* Block/tx environment (port of struct Env, app/csrc/evm.cpp) */
typedef struct {
  uint8_t coinbase[20];
  uint32_t number;
  uint32_t timestamp;
  uint32_t gas_limit;
  uint32_t chain_id;
  u256 basefee;
  u256 blob_basefee;
  u256 prevrandao;
  u256 blob_hashes[8];
  uint32_t n_blob_hashes;
  /* per-tx */
  uint8_t origin[20];
  u256 gas_price;
  /* ancestor header hashes for BLOCKHASH: filled by block.c */
  uint32_t n_ancestors;
  uint32_t ancestor_first;        /* number of headers[0] (the parent) */
  const uint8_t *ancestor_hashes; /* 32 bytes each, parent first */
  uint32_t is_prague;             /* EIP-7702/2537/7623 surface */
} gevm_env;

extern gevm_env ENV;

typedef struct {
  uint32_t success;
  uint32_t gas_left;
  uint8_t *out;
  uint32_t out_len;
} callres;

/* One transaction's execution context (evm_exec_tx port). access_list
 * is packed [addr(20) | n_slots(u32 LE) | slots(32 each)]*. */
typedef struct {
  uint8_t from[20];
  const uint8_t *to;            /* NULL = create */
  u256 value;
  uint32_t gas_limit;
  u256 eff_gas_price;
  u256 tip_per_gas;
  const uint8_t *data;
  uint32_t data_len;
  const uint8_t *access_list;
  uint32_t acl_len;
  const uint8_t *blob_hashes;
  uint32_t n_blobs;
  u256 blob_fee;
  uint32_t tx_nonce;
  /* EIP-7702: raw RLP payload of the authorization list (type 4) */
  const uint8_t *auth_rlp;
  uint32_t auth_rlp_len;
  uint32_t n_auth;
} txctx;

/* Returns 1 success, 0 revert, -1 invalid tx (caller faults the block). */
int gevm_exec_tx(const txctx *c, uint32_t *out_gas_used);

/* EIP-4788-style system call (state commits, logs/output dropped) */
void gevm_system_call(const uint8_t to[20], const uint8_t *data,
                      uint32_t data_len);

/* System call capturing the return data (EIP-7002/7251 request
 * contracts). Returns output length (buffer gmalloc'd into *out), or
 * -1 if the target has no code (caller faults the block). */
int gevm_system_call_out(const uint8_t to[20], const uint8_t *data,
                         uint32_t data_len, uint8_t **out);

#endif
