/* Guest world state: account/storage caches over the witness tries,
 * with an undo journal for call reverts and a post-state root pass.
 *
 * Port target: the journaled state of app/csrc/evm.cpp (struct Evm) +
 * SparseState.calculate_state_root (app/state.py; reference
 * crates/core/src/lib.rs:189-240 — inserts before removals). */
#include <stdint.h>
#include <string.h>
#include <alloc.h>
#include <zeth.h>
#include <keccak.h>
#include <rlp.h>
#include <trie.h>
#include <u256.h>
#include <gstate.h>

const uint8_t GS_EMPTY_CODE_HASH[32] = {
  0xc5, 0xd2, 0x46, 0x01, 0x86, 0xf7, 0x23, 0x3c, 0x92, 0x7e, 0x7d, 0xb2,
  0xdc, 0xc7, 0x03, 0xc0, 0xe5, 0x00, 0xb6, 0x53, 0xca, 0x82, 0x27, 0x3b,
  0x7b, 0xfa, 0xd8, 0x04, 0x5d, 0x85, 0xa4, 0x70};

/* -- code store (keccak(code) -> bytes), from witness + created ---------- */

typedef struct code_ent {
  uint8_t hash[32];
  uint8_t *code;
  uint32_t len;
  struct code_ent *next;
} code_ent;

#define CODE_BUCKETS 512
static code_ent *code_tab[CODE_BUCKETS];

static uint32_t hash4(const uint8_t *h) {
  return (uint32_t)h[0] | ((uint32_t)h[1] << 8) | ((uint32_t)h[2] << 16)
         | ((uint32_t)h[3] << 24);
}

void gs_add_code(const uint8_t *code, uint32_t len) {
  code_ent *e = (code_ent *)gcalloc(sizeof(code_ent));
  keccak256(code, len, e->hash);
  e->code = (uint8_t *)code;
  e->len = len;
  {
    uint32_t b = hash4(e->hash) & (CODE_BUCKETS - 1);
    e->next = code_tab[b];
    code_tab[b] = e;
  }
}

static uint8_t *code_lookup(const uint8_t hash[32], uint32_t *len) {
  code_ent *e = code_tab[hash4(hash) & (CODE_BUCKETS - 1)];
  while (e) {
    if (memcmp(e->hash, hash, 32) == 0) {
      *len = e->len;
      return e->code;
    }
    e = e->next;
  }
  return 0;
}

/* -- account map ---------------------------------------------------------- */

#define ACCT_BUCKETS 1024
static gacct *acct_tab[ACCT_BUCKETS];
static gacct *acct_list[4096];
static uint32_t acct_count;
static trie_t state_trie;

/* created_this_tx / destroyed sets: small arrays of gacct* */
static gacct *created_set[256];
static uint32_t created_n;
static gacct *destroyed_set[64];
static uint32_t destroyed_n;

static uint32_t tx_epoch_cur = 1;
static uint32_t refund_ctr;

void gs_init(const uint8_t state_root[32]) {
  trie_from_root(&state_trie, state_root);
}

uint32_t gs_was_created_this_tx(const gacct *a) {
  uint32_t i;
  for (i = 0; i < created_n; i++)
    if (created_set[i] == (const gacct *)a) return 1;
  return 0;
}

gacct *gs_account(const uint8_t addr[20]) {
  uint32_t b = (hash4(addr) ^ addr[19]) & (ACCT_BUCKETS - 1);
  gacct *a = acct_tab[b];
  uint8_t hk[32];
  const uint8_t *leaf;
  uint32_t leaf_len;
  while (a) {
    if (memcmp(a->addr, addr, 20) == 0) return a;
    a = a->next;
  }
  a = (gacct *)gcalloc(sizeof(gacct));
  memcpy(a->addr, addr, 20);
  keccak256(addr, 20, hk);
  leaf = trie_get(&state_trie, hk, 32, &leaf_len);
  if (leaf) {
    rlp_t top, it;
    if (!rlp_parse(leaf, leaf + leaf_len, &top) || !top.is_list)
      gpanic("bad account rlp", 60);
    a->exists = 1;
    rlp_at(&top, 0, &it);
    if (it.len > 4) gpanic("nonce too large", 61);
    a->nonce = rlp_u32(&it);
    rlp_at(&top, 1, &it);
    rlp_u256(&it, &a->balance);
    rlp_at(&top, 2, &it);
    if (it.len != 32) gpanic("bad storage root", 62);
    memcpy(a->storage_root, it.p, 32);
    rlp_at(&top, 3, &it);
    if (it.len != 32) gpanic("bad code hash", 63);
    memcpy(a->code_hash, it.p, 32);
  } else {
    memcpy(a->code_hash, GS_EMPTY_CODE_HASH, 32);
    memcpy(a->storage_root, TRIE_EMPTY_ROOT, 32);
  }
  a->next = acct_tab[b];
  acct_tab[b] = a;
  if (acct_count >= 4096) gpanic("too many accounts", 64);
  a->idx = acct_count;
  acct_list[acct_count++] = a;
  return a;
}

uint8_t *gs_code(gacct *a, uint32_t *len) {
  if (!a->code_loaded) {
    if (a->exists && memcmp(a->code_hash, GS_EMPTY_CODE_HASH, 32) != 0) {
      a->code = code_lookup(a->code_hash, &a->code_len);
      if (a->code == 0) gpanic("witness is missing contract code", 65);
    }
    a->code_loaded = 1;
  }
  *len = a->code_len;
  return a->code;
}

/* -- storage slot map ------------------------------------------------------ */

#define SLOT_BUCKETS 8192
typedef struct slot_node {
  slot_ent e;
  struct slot_node *next;
} slot_node;
static slot_node *slot_tab[SLOT_BUCKETS];
static slot_node *slot_list[32768];
static uint32_t slot_count;

static uint32_t slot_hash(const uint8_t addr[20], const uint8_t key[32]) {
  uint32_t h = hash4(addr) ^ hash4(key) ^ hash4(key + 28) ^ addr[16];
  return h & (SLOT_BUCKETS - 1);
}

static void open_storage(gacct *a) {
  if (!a->storage_open) {
    trie_from_root(&a->storage, a->storage_root);
    a->storage_open = 1;
  }
}

static slot_node *slot_find(gacct *a, const uint8_t key[32], uint32_t make) {
  uint32_t b = slot_hash(a->addr, key);
  slot_node *n = slot_tab[b];
  while (n) {
    if (memcmp(n->e.addr, a->addr, 20) == 0
        && memcmp(n->e.key, key, 32) == 0)
      return n;
    n = n->next;
  }
  if (!make) return 0;
  n = (slot_node *)gcalloc(sizeof(slot_node));
  memcpy(n->e.addr, a->addr, 20);
  memcpy(n->e.key, key, 32);
  /* first touch this block: read the pre-state trie (unless the account
   * was created this tx — its storage starts empty) */
  if (!gs_was_created_this_tx(a)) {
    uint8_t hk[32];
    const uint8_t *v;
    uint32_t vlen;
    open_storage(a);
    keccak256(key, 32, hk);
    v = trie_get(&a->storage, hk, 32, &vlen);
    if (v) {
      rlp_t it;
      if (!rlp_parse(v, v + vlen, &it)) gpanic("bad slot rlp", 66);
      rlp_u256(&it, &n->e.pre);
    }
  }
  n->e.value = n->e.pre;
  n->e.original = n->e.pre;
  n->e.tx_epoch = tx_epoch_cur;
  n->e.used = 1;
  n->next = slot_tab[b];
  slot_tab[b] = n;
  if (slot_count >= 32768) gpanic("too many slots", 67);
  slot_list[slot_count++] = n;
  return n;
}

static void slot_epoch(slot_node *n) {
  if (n->e.tx_epoch != tx_epoch_cur) {
    n->e.original = n->e.value;
    n->e.warm = 0;
    n->e.tx_epoch = tx_epoch_cur;
  }
}

void gs_sload(gacct *a, const uint8_t key[32], u256 *out) {
  slot_node *n = slot_find(a, key, 1);
  slot_epoch(n);
  *out = n->e.value;
}

void gs_original(gacct *a, const uint8_t key[32], u256 *out) {
  slot_node *n = slot_find(a, key, 1);
  slot_epoch(n);
  *out = n->e.original;
}

/* transient slots (EIP-1153) live in their own map: they must not pull
 * trie witness for never-persisted keys */
static slot_node *tslot_tab[1024];

static slot_node *tslot_find(gacct *a, const uint8_t key[32]) {
  uint32_t b = (hash4(a->addr) ^ hash4(key) ^ hash4(key + 28)) & 1023u;
  slot_node *n = tslot_tab[b];
  while (n) {
    if (memcmp(n->e.addr, a->addr, 20) == 0
        && memcmp(n->e.key, key, 32) == 0)
      return n;
    n = n->next;
  }
  n = (slot_node *)gcalloc(sizeof(slot_node));
  memcpy(n->e.addr, a->addr, 20);
  memcpy(n->e.key, key, 32);
  n->next = tslot_tab[b];
  tslot_tab[b] = n;
  return n;
}

void gs_tload(gacct *a, const uint8_t key[32], u256 *out) {
  slot_node *n = tslot_find(a, key);
  if (n->e.tepoch == tx_epoch_cur) *out = n->e.tvalue;
  else u256_zero(out);
}

/* -- journal -------------------------------------------------------------- */

#define J_CAP 65536
static jentry *journal;
static uint32_t j_len;
static glog *log_head, *log_tail;
static uint32_t log_count_all;
static uint32_t tx_log_start;
static glog *tx_log_head;

static void jpush(jentry *e) {
  if (journal == 0) journal = (jentry *)gmalloc(J_CAP * sizeof(jentry));
  if (j_len >= J_CAP) gpanic("journal overflow", 68);
  journal[j_len++] = *e;
}

uint32_t gs_snapshot(void) { return j_len; }

void gs_revert(uint32_t snap) {
  while (j_len > snap) {
    jentry *e = &journal[--j_len];
    switch (e->kind) {
      case J_BALANCE: e->acc->balance = e->prev_val; break;
      case J_NONCE: e->acc->nonce = e->prev_u32; break;
      case J_STORAGE: e->slot->value = e->prev_val; break;
      case J_TSTORE: e->slot->tvalue = e->prev_val; break;
      case J_CODE:
        memcpy(e->acc->code_hash, e->prev_hash, 32);
        e->acc->code = e->prev_code;
        e->acc->code_len = e->prev_code_len;
        break;
      case J_CREATED: {
        uint32_t i;
        e->acc->exists = e->prev_flag;
        for (i = 0; i < created_n; i++)
          if (created_set[i] == e->acc) {
            created_set[i] = created_set[--created_n];
            break;
          }
        break;
      }
      case J_WARM_ACC: acct_warm_epoch[e->prev_u32] = 0; break;
      case J_WARM_SLOT: e->slot->warm = 0; break;
      case J_LOG: {
        /* drop the tail log */
        glog *g = log_head, *prev = 0;
        while (g && g->next) { prev = g; g = g->next; }
        if (prev) { prev->next = 0; log_tail = prev; }
        else { log_head = log_tail = 0; }
        log_count_all--;
        break;
      }
      case J_DESTROYED: {
        uint32_t i;
        for (i = 0; i < destroyed_n; i++)
          if (destroyed_set[i] == e->acc) {
            destroyed_set[i] = destroyed_set[--destroyed_n];
            break;
          }
        break;
      }
      case J_REFUND: refund_ctr = e->prev_u32; break;
      default: gpanic("bad journal entry", 69);
    }
  }
}

void gs_set_balance(gacct *a, const u256 *v) {
  jentry e;
  memset(&e, 0, sizeof(e));
  e.kind = J_BALANCE;
  e.acc = a;
  e.prev_val = a->balance;
  jpush(&e);
  a->balance = *v;
}

void gs_set_nonce(gacct *a, uint32_t v) {
  jentry e;
  memset(&e, 0, sizeof(e));
  e.kind = J_NONCE;
  e.acc = a;
  e.prev_u32 = a->nonce;
  jpush(&e);
  a->nonce = v;
}

void gs_sstore(gacct *a, const uint8_t key[32], const u256 *v) {
  slot_node *n = slot_find(a, key, 1);
  jentry e;
  slot_epoch(n);
  memset(&e, 0, sizeof(e));
  e.kind = J_STORAGE;
  e.slot = &n->e;
  e.prev_val = n->e.value;
  jpush(&e);
  n->e.value = *v;
}

void gs_tstore(gacct *a, const uint8_t key[32], const u256 *v) {
  slot_node *n = tslot_find(a, key);
  jentry e;
  if (n->e.tepoch != tx_epoch_cur) {
    u256_zero(&n->e.tvalue);
    n->e.tepoch = tx_epoch_cur;
  }
  memset(&e, 0, sizeof(e));
  e.kind = J_TSTORE;
  e.slot = &n->e;
  e.prev_val = n->e.tvalue;
  jpush(&e);
  n->e.tvalue = *v;
}

void gs_set_code(gacct *a, uint8_t *code, uint32_t len) {
  jentry e;
  memset(&e, 0, sizeof(e));
  e.kind = J_CODE;
  e.acc = a;
  memcpy(e.prev_hash, a->code_hash, 32);
  e.prev_code = a->code;
  e.prev_code_len = a->code_len;
  jpush(&e);
  keccak256(code, len, a->code_hash);
  a->code = code;
  a->code_len = len;
  a->code_loaded = 1;
  /* register so in-block EXTCODE* by hash and the post pass see it */
  {
    code_ent *ce = (code_ent *)gcalloc(sizeof(code_ent));
    memcpy(ce->hash, a->code_hash, 32);
    ce->code = code;
    ce->len = len;
    {
      uint32_t b = hash4(ce->hash) & (CODE_BUCKETS - 1);
      ce->next = code_tab[b];
      code_tab[b] = ce;
    }
  }
}

void gs_mark_created(gacct *a) {
  jentry e;
  memset(&e, 0, sizeof(e));
  e.kind = J_CREATED;
  e.acc = a;
  e.prev_flag = a->exists;
  jpush(&e);
  a->exists = 1;
  if (created_n >= 256) gpanic("created set overflow", 70);
  created_set[created_n++] = a;
}

void gs_add_refund(uint32_t d, uint32_t negate) {
  jentry e;
  memset(&e, 0, sizeof(e));
  e.kind = J_REFUND;
  e.prev_u32 = refund_ctr;
  jpush(&e);
  if (negate) refund_ctr -= d;
  else refund_ctr += d;
}

uint32_t gs_refund(void) { return refund_ctr; }

/* warmth: account warmth lives in storage_written bit 1 (epoch-checked
 * via warm_epoch below) */
static uint32_t acct_warm_epoch[4096];

uint32_t gs_warm_account(gacct *a) {
  if (acct_warm_epoch[a->idx] == tx_epoch_cur) return 1;
  acct_warm_epoch[a->idx] = tx_epoch_cur;
  {
    jentry e;
    memset(&e, 0, sizeof(e));
    e.kind = J_WARM_ACC;
    e.acc = a;
    e.prev_u32 = a->idx;
    jpush(&e);
  }
  return 0;
}

uint32_t gs_warm_slot(gacct *a, const uint8_t key[32]) {
  slot_node *n = slot_find(a, key, 1);
  slot_epoch(n);
  if (n->e.warm) return 1;
  n->e.warm = 1;
  {
    jentry e;
    memset(&e, 0, sizeof(e));
    e.kind = J_WARM_SLOT;
    e.slot = &n->e;
    jpush(&e);
  }
  return 0;
}

void gs_add_log(const uint8_t addr[20], uint32_t n_topics,
                const uint8_t topics[4][32], const uint8_t *data,
                uint32_t len) {
  glog *g = (glog *)gcalloc(sizeof(glog));
  uint32_t i;
  jentry e;
  memcpy(g->addr, addr, 20);
  g->n_topics = n_topics;
  for (i = 0; i < n_topics; i++) memcpy(g->topics[i], topics[i], 32);
  g->data = (uint8_t *)gmalloc(len ? len : 1);
  memcpy(g->data, data, len);
  g->data_len = len;
  if (log_tail) log_tail->next = g;
  else log_head = g;
  log_tail = g;
  log_count_all++;
  memset(&e, 0, sizeof(e));
  e.kind = J_LOG;
  jpush(&e);
}

void gs_mark_destroyed(gacct *a) {
  uint32_t i;
  jentry e;
  for (i = 0; i < destroyed_n; i++)
    if (destroyed_set[i] == a) return;
  memset(&e, 0, sizeof(e));
  e.kind = J_DESTROYED;
  e.acc = a;
  jpush(&e);
  if (destroyed_n >= 64) gpanic("destroyed set overflow", 72);
  destroyed_set[destroyed_n++] = a;
}

void gs_begin_tx(void) {
  tx_epoch_cur++;
  refund_ctr = 0;
  j_len = 0;
  created_n = 0;
  destroyed_n = 0;
  tx_log_head = log_tail;      /* marker: logs after this are tx logs */
  tx_log_start = log_count_all;
}

void gs_end_tx(void) {
  uint32_t i;
  for (i = 0; i < destroyed_n; i++) {
    gacct *a = destroyed_set[i];
    a->exists = 0;
    a->nonce = 0;
    u256_zero(&a->balance);
    memcpy(a->code_hash, GS_EMPTY_CODE_HASH, 32);
    a->code = 0;
    a->code_len = 0;
    a->code_loaded = 1;
    /* wipe its storage writes */
    {
      uint32_t k;
      for (k = 0; k < slot_count; k++)
        if (memcmp(slot_list[k]->e.addr, a->addr, 20) == 0) {
          u256_zero(&slot_list[k]->e.value);
        }
    }
  }
  destroyed_n = 0;
}

glog *gs_tx_logs(uint32_t *count) {
  *count = log_count_all - tx_log_start;
  return tx_log_head ? tx_log_head->next : log_head;
}

glog *gs_all_logs(uint32_t *count) {
  *count = log_count_all;
  return log_head;
}

/* -- post-state root -------------------------------------------------------

   Mirror of SparseState.calculate_state_root (app/state.py; reference
   core/src/lib.rs:189-240): per-account storage-root recompute, account
   upserts first, deletions last (insert-before-remove ordering). */

void gs_post_root(uint8_t out[32]) {
  uint32_t i, k;
  /* storage writes -> per-account tries */
  for (k = 0; k < slot_count; k++) {
    slot_ent *s = &slot_list[k]->e;
    gacct *a = gs_account(s->addr);
    uint8_t hk[32];
    if (u256_eq(&s->value, &s->pre)) continue;
    open_storage(a);
    a->storage_written |= 1;
    keccak256(s->key, 32, hk);
    if (u256_is_zero(&s->value)) {
      trie_delete(&a->storage, hk, 32);
    } else {
      uint8_t enc[40];
      rlpw_t w;
      rlpw_init(&w, enc, 40);
      rlpw_u256(&w, &s->value);
      trie_insert(&a->storage, hk, 32, enc, w.len);
    }
  }
  /* upserts first */
  for (i = 0; i < acct_count; i++) {
    gacct *a = acct_list[i];
    uint8_t hk[32];
    if (!a->exists) continue;
    keccak256(a->addr, 20, hk);
    {
      uint8_t sroot[32];
      uint8_t body[128];
      rlpw_t w;
      uint32_t mark;
      if (a->storage_open && (a->storage_written & 1)) {
        trie_root(&a->storage, sroot);
      } else {
        memcpy(sroot, a->storage_root, 32);
      }
      rlpw_init(&w, body, 128);
      mark = rlpw_list_begin(&w);
      rlpw_u32(&w, a->nonce);
      rlpw_u256(&w, &a->balance);
      rlpw_bytes(&w, sroot, 32);
      rlpw_bytes(&w, a->code_hash, 32);
      rlpw_list_end(&w, mark);
      if (rlpw_overflowed(&w)) gpanic("account rlp overflow", 73);
      trie_insert(&state_trie, hk, 32, body, w.len);
    }
  }
  /* deletions last */
  for (i = 0; i < acct_count; i++) {
    gacct *a = acct_list[i];
    uint8_t hk[32];
    uint32_t ll;
    if (a->exists) continue;
    keccak256(a->addr, 20, hk);
    /* only delete if present (touch-only absent accounts are no-ops) */
    if (trie_get(&state_trie, hk, 32, &ll) != 0)
      trie_delete(&state_trie, hk, 32);
  }
  trie_root(&state_trie, out);
}
