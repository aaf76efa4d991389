/* Transaction envelope decoding, signing hashes, sender recovery and
 * fee math for the stateless-client guest.
 *
 * Mirrors the host's app/txs.py (reference role: alloy typed tx
 * envelopes + reth sender recovery). The signing pre-image reuses the
 * envelope's own contiguous RLP payload: pre = type || list(items[0..k))
 * for typed txs, so no field re-encoding is needed. */
#include <stdint.h>
#include <string.h>
#include <alloc.h>
#include <zeth.h>
#include <keccak.h>
#include <rlp.h>
#include <u256.h>
#include <secp256k1.h>
#include <trie.h>
#include <gtx.h>

/* offset (relative to list payload) of item `idx` and its raw length */
static uint32_t item_slice(const rlp_t *list, uint32_t first_n,
                           const uint8_t **start, uint32_t *len) {
  const uint8_t *cur = 0;
  rlp_t it;
  uint32_t i;
  *start = list->p;
  for (i = 0; i < first_n; i++)
    if (!rlp_next(list, &cur, &it)) return 0;
  *len = (uint32_t)(cur - list->p);
  return 1;
}

static void sighash_typed(uint8_t tx_type, const rlp_t *list,
                          uint32_t n_unsigned, uint8_t out[32]) {
  const uint8_t *start;
  uint32_t plen;
  uint8_t *buf;
  rlpw_t w;
  if (!item_slice(list, n_unsigned, &start, &plen))
    gpanic("tx sighash slice", 90);
  buf = (uint8_t *)gmalloc(plen + 8);
  buf[0] = tx_type;
  rlpw_init(&w, buf + 1, plen + 7);
  {
    uint32_t mark = rlpw_list_begin(&w);
    rlpw_raw(&w, start, plen);
    rlpw_list_end(&w, mark);
    keccak256(buf, 1 + w.len, out);
  }
}

static void sighash_legacy(const rlp_t *list, uint32_t v, uint8_t out[32],
                           uint32_t *recid) {
  const uint8_t *start;
  uint32_t plen;
  uint8_t *buf;
  rlpw_t w;
  uint32_t extra = 0;
  uint8_t chain_tail[8];
  if (!item_slice(list, 6, &start, &plen)) gpanic("legacy sighash", 91);
  if (v >= 35) {
    uint32_t chain_id = (v - 35) / 2;
    rlpw_t cw;
    *recid = (v - 35) % 2;
    cw.buf = chain_tail;
    cw.len = 0;
    cw.cap = 6;
    rlpw_u32(&cw, chain_id);
    chain_tail[cw.len] = 0x80;
    chain_tail[cw.len + 1] = 0x80;
    extra = cw.len + 2;
  } else {
    if (v != 27 && v != 28) gpanic("bad legacy v", 92);
    *recid = v - 27;
  }
  buf = (uint8_t *)gmalloc(plen + extra + 8);
  w.buf = buf;
  w.len = 0;
  w.cap = plen + extra + 8;
  {
    uint32_t mark = rlpw_list_begin(&w);
    rlpw_raw(&w, start, plen);
    rlpw_raw(&w, chain_tail, extra);
    rlpw_list_end(&w, mark);
    keccak256(w.buf, w.len, out);
  }
}

/* convert an RLP access list into the packed [addr|n|slots] format */
static void pack_acl(const rlp_t *acl, uint8_t **out, uint32_t *out_len) {
  const uint8_t *cur = 0;
  rlp_t entry, it, keys;
  uint32_t total = 0;
  /* size pass */
  while (rlp_next(acl, &cur, &entry)) {
    if (!rlp_at(&entry, 1, &keys)) gpanic("acl entry", 93);
    total += 24 + 32 * rlp_count(&keys);
  }
  *out = (uint8_t *)gmalloc(total ? total : 1);
  *out_len = total;
  {
    uint8_t *p = *out;
    cur = 0;
    while (rlp_next(acl, &cur, &entry)) {
      const uint8_t *kcur = 0;
      uint32_t ns;
      rlp_at(&entry, 0, &it);
      if (it.len != 20) gpanic("acl addr", 94);
      memcpy(p, it.p, 20);
      rlp_at(&entry, 1, &keys);
      ns = rlp_count(&keys);
      p[20] = (uint8_t)ns;
      p[21] = (uint8_t)(ns >> 8);
      p[22] = (uint8_t)(ns >> 16);
      p[23] = (uint8_t)(ns >> 24);
      p += 24;
      while (rlp_next(&keys, &kcur, &it)) {
        if (it.len != 32) gpanic("acl key", 95);
        memcpy(p, it.p, 32);
        p += 32;
      }
    }
  }
}

void gtx_parse(const uint8_t *env, uint32_t env_len, gtx *tx) {
  const uint8_t *body = env;
  uint32_t body_len = env_len;
  rlp_t list, it;
  uint32_t n;

  memset(tx, 0, sizeof(gtx));
  tx->envelope = env;
  tx->envelope_len = env_len;
  if (env_len == 0) gpanic("empty tx", 96);
  if (env[0] <= 0x7f) {
    tx->type = env[0];
    if (tx->type > 4) gpanic("unsupported tx type", 97);
    body = env + 1;
    body_len = env_len - 1;
  } else {
    tx->type = 0;
  }
  if (!rlp_parse(body, body + body_len, &list) || !list.is_list)
    gpanic("tx rlp", 98);
  n = rlp_count(&list);

  if (tx->type == 0) {
    uint32_t v;
    if (n != 9) gpanic("legacy tx arity", 99);
    rlp_at(&list, 0, &it);
    tx->nonce = rlp_u32(&it);
    rlp_at(&list, 1, &it);
    rlp_u256(&it, &tx->gas_price);
    rlp_at(&list, 2, &it);
    tx->gas_limit = rlp_u32(&it);
    rlp_at(&list, 3, &it);
    tx->has_to = it.len == 20;
    if (it.len != 0 && it.len != 20) gpanic("tx to", 100);
    if (tx->has_to) memcpy(tx->to, it.p, 20);
    rlp_at(&list, 4, &it);
    rlp_u256(&it, &tx->value);
    rlp_at(&list, 5, &it);
    tx->data = it.p;
    tx->data_len = it.len;
    rlp_at(&list, 6, &it);
    v = rlp_u32(&it);
    rlp_at(&list, 7, &it);
    rlp_u256(&it, &tx->r);
    rlp_at(&list, 8, &it);
    rlp_u256(&it, &tx->s);
    sighash_legacy(&list, v, tx->sighash, &tx->recid);
    tx->chain_id = v >= 35 ? (v - 35) / 2 : 0;
    return;
  }

  /* typed: [chainid, nonce, (prices...), gaslimit, to, value, data, acl,
   *         (blob fields | auth list), yparity, r, s] */
  {
    uint32_t idx = 0;
    uint32_t want = tx->type == 1 ? 11
                    : (tx->type == 2 ? 12 : (tx->type == 3 ? 14 : 13));
    rlp_t acl;
    if (n != want) gpanic("typed tx arity", 101);
    rlp_at(&list, idx++, &it);
    tx->chain_id = rlp_u32(&it);
    rlp_at(&list, idx++, &it);
    tx->nonce = rlp_u32(&it);
    if (tx->type == 1) {
      rlp_at(&list, idx++, &it);
      rlp_u256(&it, &tx->gas_price);
    } else {
      rlp_at(&list, idx++, &it);
      rlp_u256(&it, &tx->max_priority_fee);
      rlp_at(&list, idx++, &it);
      rlp_u256(&it, &tx->max_fee);
    }
    rlp_at(&list, idx++, &it);
    tx->gas_limit = rlp_u32(&it);
    rlp_at(&list, idx++, &it);
    tx->has_to = it.len == 20;
    if (it.len != 0 && it.len != 20) gpanic("tx to", 102);
    if (tx->has_to) memcpy(tx->to, it.p, 20);
    rlp_at(&list, idx++, &it);
    rlp_u256(&it, &tx->value);
    rlp_at(&list, idx++, &it);
    tx->data = it.p;
    tx->data_len = it.len;
    rlp_at(&list, idx++, &acl);
    pack_acl(&acl, &tx->acl, &tx->acl_len);
    if (tx->type == 3) {
      rlp_at(&list, idx++, &it);
      rlp_u256(&it, &tx->max_fee_per_blob_gas);
      rlp_at(&list, idx++, &it);
      {
        const uint8_t *cur = 0;
        rlp_t bh;
        tx->n_blobs = rlp_count(&it);
        if (tx->n_blobs > 8) gpanic("too many blobs", 103);
        tx->blob_hashes = (uint8_t *)gmalloc(
            tx->n_blobs ? 32 * tx->n_blobs : 1);
        {
          uint32_t k = 0;
          while (rlp_next(&it, &cur, &bh)) {
            if (bh.len != 32) gpanic("blob hash", 104);
            memcpy(tx->blob_hashes + 32 * k, bh.p, 32);
            k++;
          }
        }
      }
    }
    if (tx->type == 4) {                  /* EIP-7702 authorization list */
      rlp_t auth;
      rlp_at(&list, idx++, &auth);
      if (!auth.is_list) gpanic("auth list", 107);
      tx->auth_rlp = auth.p;
      tx->auth_rlp_len = auth.len;
      tx->n_auth = rlp_count(&auth);
      if (tx->n_auth == 0) gpanic("empty auth list", 108);
      if (!tx->has_to) gpanic("type-4 create", 109);
    }
    sighash_typed((uint8_t)tx->type, &list, idx, tx->sighash);
    rlp_at(&list, idx++, &it);
    tx->recid = rlp_u32(&it);
    rlp_at(&list, idx++, &it);
    rlp_u256(&it, &tx->r);
    rlp_at(&list, idx++, &it);
    rlp_u256(&it, &tx->s);
  }
}

void gtx_sender(const gtx *tx, uint8_t out[20]) {
  uint32_t rec = tx->recid;
  if (rec >= 27) rec -= 27;
  if (rec > 1) gpanic("bad recovery id", 105);
  if (!secp_ecrecover(tx->sighash, rec, &tx->r, &tx->s, out))
    gpanic("sender recovery failed", 106);
}

/* (effective price, tip per gas) — app/txs.py effective_gas_price */
void gtx_effective_price(const gtx *tx, const u256 *basefee, u256 *eff,
                         u256 *tip) {
  if (tx->type <= 1) {
    *eff = tx->gas_price;
  } else {
    u256 cap;
    u256_add(&cap, basefee, &tx->max_priority_fee);
    *eff = u256_cmp(&tx->max_fee, &cap) < 0 ? tx->max_fee : cap;
  }
  if (u256_cmp(eff, basefee) >= 0) u256_sub(tip, eff, basefee);
  else u256_zero(tip);
}
