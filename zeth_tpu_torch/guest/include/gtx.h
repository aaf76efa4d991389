#ifndef _G_TX_H
#define _G_TX_H
#include <stdint.h>
#include <u256.h>

typedef struct {
  uint32_t type;
  uint32_t chain_id;
  uint32_t nonce;
  uint32_t gas_limit;
  uint32_t has_to;
  uint8_t to[20];
  u256 value;
  u256 gas_price;           /* legacy / 2930 */
  u256 max_fee;             /* 1559 / 4844 */
  u256 max_priority_fee;
  u256 max_fee_per_blob_gas;
  const uint8_t *data;
  uint32_t data_len;
  uint8_t *acl;             /* packed [addr|n_slots u32|slots]* */
  uint32_t acl_len;
  uint8_t *blob_hashes;     /* 32 bytes each */
  uint32_t n_blobs;
  /* EIP-7702 (type 4): raw RLP slice of the authorization list */
  const uint8_t *auth_rlp;
  uint32_t auth_rlp_len;
  uint32_t n_auth;
  uint32_t recid;
  u256 r, s;
  uint8_t sighash[32];
  const uint8_t *envelope;
  uint32_t envelope_len;
} gtx;

void gtx_parse(const uint8_t *env, uint32_t env_len, gtx *tx);
void gtx_sender(const gtx *tx, uint8_t out[20]);
void gtx_effective_price(const gtx *tx, const u256 *basefee, u256 *eff,
                         u256 *tip);

#endif
