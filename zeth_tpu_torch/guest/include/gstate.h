#ifndef _G_STATE_H
#define _G_STATE_H
#include <stdint.h>
#include <u256.h>
#include <trie.h>

/* Journaled in-guest world state over the witness tries (the role of
 * revm's journaled state + zeth-core's SparseState inside the guest,
 * SURVEY.md §2.1 crates/core/src/lib.rs:94-240). */

typedef struct gacct {
  uint8_t addr[20];
  uint32_t exists;
  uint32_t nonce;
  u256 balance;
  uint8_t code_hash[32];
  uint8_t *code;
  uint32_t code_len;
  uint32_t code_loaded;
  uint8_t storage_root[32];       /* pre-state root from the account RLP */
  trie_t storage;                  /* hydrates lazily */
  uint32_t storage_open;
  uint32_t storage_written;
  uint32_t idx;                   /* position in the touched-account list */
  struct gacct *next;
} gacct;

typedef struct slot_ent {
  uint8_t addr[20];
  uint8_t key[32];
  u256 value;          /* current */
  u256 original;       /* tx-start value */
  u256 pre;            /* block-start (trie) value */
  uint32_t used;
  uint32_t warm;
  uint32_t tx_epoch;   /* original/warm validity epoch */
  u256 tvalue;         /* EIP-1153 transient (valid when tepoch matches) */
  uint32_t tepoch;
} slot_ent;

typedef struct glog {
  uint8_t addr[20];
  uint32_t n_topics;
  uint8_t topics[4][32];
  uint8_t *data;
  uint32_t data_len;
  struct glog *next;   /* journal undo chain keeps a count instead */
} glog;

/* journal entry kinds */
enum {
  J_BALANCE = 1, J_NONCE, J_STORAGE, J_TSTORE, J_CODE, J_CREATED,
  J_WARM_ACC, J_WARM_SLOT, J_LOG, J_DESTROYED, J_REFUND
};

typedef struct {
  uint32_t kind;
  gacct *acc;
  slot_ent *slot;
  u256 prev_val;
  uint32_t prev_u32;
  uint8_t prev_hash[32];
  uint8_t *prev_code;
  uint32_t prev_code_len;
  uint32_t prev_flag;
} jentry;

void gs_init(const uint8_t state_root[32]);
void gs_add_code(const uint8_t *code, uint32_t len);   /* witness code */

gacct *gs_account(const uint8_t addr[20]);
uint8_t *gs_code(gacct *a, uint32_t *len);             /* loads lazily */
void gs_sload(gacct *a, const uint8_t key[32], u256 *out);
void gs_original(gacct *a, const uint8_t key[32], u256 *out);
void gs_tload(gacct *a, const uint8_t key[32], u256 *out);

uint32_t gs_snapshot(void);
void gs_revert(uint32_t snap);

void gs_set_balance(gacct *a, const u256 *v);
void gs_set_nonce(gacct *a, uint32_t v);
void gs_sstore(gacct *a, const uint8_t key[32], const u256 *v);
void gs_tstore(gacct *a, const uint8_t key[32], const u256 *v);
void gs_set_code(gacct *a, uint8_t *code, uint32_t len);
void gs_mark_created(gacct *a);
uint32_t gs_was_created_this_tx(const gacct *a);
void gs_add_refund(uint32_t d, uint32_t negate);
uint32_t gs_refund(void);
uint32_t gs_warm_account(gacct *a);     /* returns prior warmth; warms */
uint32_t gs_warm_slot(gacct *a, const uint8_t key[32]);
void gs_add_log(const uint8_t addr[20], uint32_t n_topics,
                const uint8_t topics[4][32], const uint8_t *data,
                uint32_t len);
void gs_mark_destroyed(gacct *a);

/* per-tx reset (warm sets, tstorage, original storage, refund, journal) */
void gs_begin_tx(void);
/* EIP-6780: wipe accounts destroyed this tx */
void gs_end_tx(void);

/* logs of the current tx (since gs_begin_tx) */
glog *gs_tx_logs(uint32_t *count);
glog *gs_all_logs(uint32_t *count);

/* post-state root over all touched accounts/slots */
void gs_post_root(uint8_t out[32]);

extern const uint8_t GS_EMPTY_CODE_HASH[32];

#endif
