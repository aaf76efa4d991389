#ifndef _G_TRIE_H
#define _G_TRIE_H
#include <stdint.h>

/* Sparse Merkle-Patricia trie over keccak-256, hydrated on demand from
 * a witness node store (the in-guest role of risc0-ethereum-trie,
 * SURVEY.md §2.2). Unresolvable digest references fault the guest:
 * the witness was insufficient, exactly the reference's
 * orphan::Error::Unresolvable condition. */

enum { T_NULL = 0, T_HASHREF = 1, T_LEAF = 2, T_EXT = 3, T_BRANCH = 4 };

typedef struct tnode {
  uint8_t kind;
  uint8_t dirty;             /* encoding/hash caches invalid */
  uint8_t enc_len;           /* cached node reference: 32 = hash, <32 raw */
  uint8_t enc[32];           /* hash or inline encoding */
  uint8_t *path;             /* leaf/ext nibble path */
  uint32_t path_len;
  uint8_t *value;            /* leaf (or branch) value */
  uint32_t value_len;
  struct tnode *child;       /* ext */
  struct tnode *kids[16];    /* branch (NULL = empty) */
} tnode;

/* -- witness node store (shared by state + storage tries) --------------- */
void store_init(uint32_t capacity_pow2);
void store_add(const uint8_t *rlp_node, uint32_t len);  /* hashes + indexes */
const uint8_t *store_get(const uint8_t hash[32], uint32_t *len);

/* -- trie ---------------------------------------------------------------- */
typedef struct {
  tnode *root;               /* NULL = empty trie */
} trie_t;

void trie_from_root(trie_t *t, const uint8_t root[32]);
/* get: returns value bytes or NULL; *len set. Faults on missing nodes. */
const uint8_t *trie_get(trie_t *t, const uint8_t *key, uint32_t key_len,
                        uint32_t *len);
void trie_insert(trie_t *t, const uint8_t *key, uint32_t key_len,
                 const uint8_t *value, uint32_t value_len);
void trie_delete(trie_t *t, const uint8_t *key, uint32_t key_len);
void trie_root(trie_t *t, uint8_t out[32]);

extern const uint8_t TRIE_EMPTY_ROOT[32];

/* guest panic: logs msg and halts(code) */
void gpanic(const char *msg, uint32_t code);

#endif
