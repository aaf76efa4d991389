/* Guest sparse MPT: witness store, lazy hydration, get/insert/delete,
 * root recomputation.
 *
 * Independent C implementation of the trie semantics the host app uses
 * (zeth_tpu_torch/app/trie.py; reference role risc0-ethereum-trie,
 * crates/core/src/lib.rs:135-240). Nodes hydrate from the witness store
 * on first touch; digest references without a stored preimage fault the
 * guest (insufficient witness).
 */
#include <stdint.h>
#include <string.h>
#include <alloc.h>
#include <zeth.h>
#include <keccak.h>
#include <rlp.h>
#include <trie.h>

const uint8_t TRIE_EMPTY_ROOT[32] = {
  0x56, 0xe8, 0x1f, 0x17, 0x1b, 0xcc, 0x55, 0xa6, 0xff, 0x83, 0x45, 0xe6,
  0x92, 0xc0, 0xf8, 0x6e, 0x5b, 0x48, 0xe0, 0x1b, 0x99, 0x6c, 0xad, 0xc0,
  0x01, 0x62, 0x2f, 0xb5, 0xe3, 0x63, 0xb4, 0x21};

void gpanic(const char *msg, uint32_t code) {
  env_log(msg, strlen(msg));
  env_halt(code);
  for (;;) {}
}

/* -- witness store: open-addressing hash map digest -> (ptr, len) -------- */

typedef struct {
  uint8_t hash[32];
  const uint8_t *node;
  uint32_t len;
} store_ent;

static store_ent *store_tab;
static uint32_t store_mask;
static uint32_t store_n;

void store_init(uint32_t capacity_pow2) {
  store_tab = (store_ent *)gcalloc(capacity_pow2 * sizeof(store_ent));
  store_mask = capacity_pow2 - 1;
  store_n = 0;
}

static uint32_t h32(const uint8_t h[32]) {
  return (uint32_t)h[0] | ((uint32_t)h[1] << 8) | ((uint32_t)h[2] << 16)
         | ((uint32_t)h[3] << 24);
}

static store_ent *store_slot(const uint8_t hash[32]) {
  uint32_t i = h32(hash) & store_mask;
  for (;;) {
    store_ent *e = store_tab + i;
    if (e->node == 0 || memcmp(e->hash, hash, 32) == 0) return e;
    i = (i + 1) & store_mask;
  }
}

void store_add(const uint8_t *rlp_node, uint32_t len) {
  uint8_t h[32];
  store_ent *e;
  keccak256(rlp_node, len, h);
  if (store_n * 2 >= store_mask) gpanic("store full", 40);
  e = store_slot(h);
  if (e->node == 0) {
    memcpy(e->hash, h, 32);
    e->node = rlp_node;
    e->len = len;
    store_n++;
  }
}

const uint8_t *store_get(const uint8_t hash[32], uint32_t *len) {
  store_ent *e = store_slot(hash);
  if (e->node == 0) return 0;
  *len = e->len;
  return e->node;
}

/* -- node construction ---------------------------------------------------- */

static tnode *nnew(uint32_t kind) {
  tnode *n = (tnode *)gcalloc(sizeof(tnode));
  n->kind = (uint8_t)kind;
  n->dirty = 1;
  return n;
}

static uint8_t *nib_dup(const uint8_t *p, uint32_t n) {
  uint8_t *d = (uint8_t *)gmalloc(n ? n : 1);
  memcpy(d, p, n);
  return d;
}

/* decode hex-prefix into (nibbles, is_leaf) */
static uint8_t *hp_decode(const uint8_t *p, uint32_t len, uint32_t *n_out,
                          uint32_t *leaf_out) {
  uint32_t flag = p[0] >> 4;
  uint32_t odd = flag & 1;
  uint32_t n = (len - 1) * 2 + odd;
  uint8_t *nib = (uint8_t *)gmalloc(n ? n : 1);
  uint32_t i, j = 0;
  if (odd) nib[j++] = p[0] & 0xF;
  for (i = 1; i < len; i++) {
    nib[j++] = p[i] >> 4;
    nib[j++] = p[i] & 0xF;
  }
  *n_out = n;
  *leaf_out = (flag >> 1) & 1;
  return nib;
}

static uint32_t hp_encode(const uint8_t *nib, uint32_t n, uint32_t leaf,
                          uint8_t *out) {
  uint32_t flag = (leaf ? 2u : 0u) | (n & 1);
  uint32_t i = 0, o = 0;
  if (n & 1) {
    out[o++] = (uint8_t)((flag << 4) | nib[0]);
    i = 1;
  } else {
    out[o++] = (uint8_t)(flag << 4);
  }
  for (; i < n; i += 2)
    out[o++] = (uint8_t)((nib[i] << 4) | nib[i + 1]);
  return o;
}

/* parse an RLP node (raw bytes) into a tnode */
static tnode *parse_node(const uint8_t *p, uint32_t len);

/* a child reference inside a node: 32B string = hashref; <32B raw = inline
 * node; empty string = NULL */
static tnode *parse_ref(const rlp_t *it) {
  tnode *n;
  if (it->is_list) return parse_node(it->raw, it->raw_len);
  if (it->len == 0) return 0;
  if (it->len != 32) gpanic("bad child ref", 41);
  n = nnew(T_HASHREF);
  memcpy(n->enc, it->p, 32);
  n->enc_len = 32;
  n->dirty = 0;
  return n;
}

static tnode *parse_node(const uint8_t *p, uint32_t len) {
  rlp_t top, it;
  uint32_t cnt;
  tnode *n;
  if (!rlp_parse(p, p + len, &top) || !top.is_list)
    gpanic("bad trie node", 42);
  cnt = rlp_count(&top);
  if (cnt == 2) {
    uint32_t pn, leaf;
    rlp_t hp, val;
    rlp_at(&top, 0, &hp);
    rlp_at(&top, 1, &val);
    {
      uint8_t *nib = hp_decode(hp.p, hp.len, &pn, &leaf);
      if (leaf) {
        n = nnew(T_LEAF);
        n->path = nib;
        n->path_len = pn;
        n->value = nib_dup(val.p, val.len);
        n->value_len = val.len;
      } else {
        n = nnew(T_EXT);
        n->path = nib;
        n->path_len = pn;
        n->child = parse_ref(&val);
        if (n->child == 0) gpanic("ext to null", 43);
      }
    }
    return n;
  }
  if (cnt == 17) {
    uint32_t i;
    n = nnew(T_BRANCH);
    for (i = 0; i < 16; i++) {
      rlp_at(&top, i, &it);
      n->kids[i] = parse_ref(&it);
    }
    rlp_at(&top, 16, &it);
    if (it.len) {
      n->value = nib_dup(it.p, it.len);
      n->value_len = it.len;
    }
    return n;
  }
  gpanic("trie node arity", 44);
  return 0;
}

/* resolve a HASHREF in place (returns the hydrated node) */
static tnode *resolve(tnode *n) {
  const uint8_t *p;
  uint32_t len;
  tnode *r;
  if (n == 0 || n->kind != T_HASHREF) return n;
  p = store_get(n->enc, &len);
  if (p == 0) gpanic("missing trie node (witness insufficient)", 45);
  r = parse_node(p, len);
  /* keep the known encoding: clean until modified */
  memcpy(r->enc, n->enc, 32);
  r->enc_len = 32;
  r->dirty = 0;
  *n = *r;
  return n;
}

void trie_from_root(trie_t *t, const uint8_t root[32]) {
  if (memcmp(root, TRIE_EMPTY_ROOT, 32) == 0) {
    t->root = 0;
    return;
  }
  t->root = nnew(T_HASHREF);
  memcpy(t->root->enc, root, 32);
  t->root->enc_len = 32;
  t->root->dirty = 0;
}

/* -- get ------------------------------------------------------------------ */

static uint8_t key_nib_buf[80];

static uint8_t *to_nibbles(const uint8_t *key, uint32_t key_len) {
  uint32_t i;
  if (key_len > 40) gpanic("key too long", 46);
  for (i = 0; i < key_len; i++) {
    key_nib_buf[2 * i] = key[i] >> 4;
    key_nib_buf[2 * i + 1] = key[i] & 0xF;
  }
  return key_nib_buf;
}

const uint8_t *trie_get(trie_t *t, const uint8_t *key, uint32_t key_len,
                        uint32_t *len) {
  uint8_t *nib = to_nibbles(key, key_len);
  uint32_t n = key_len * 2, pos = 0;
  tnode *cur = t->root;
  *len = 0;
  while (cur) {
    cur = resolve(cur);
    if (cur->kind == T_LEAF) {
      if (cur->path_len == n - pos
          && memcmp(cur->path, nib + pos, cur->path_len) == 0) {
        *len = cur->value_len;
        return cur->value;
      }
      return 0;
    }
    if (cur->kind == T_EXT) {
      if (n - pos < cur->path_len
          || memcmp(cur->path, nib + pos, cur->path_len) != 0)
        return 0;
      pos += cur->path_len;
      cur = cur->child;
      continue;
    }
    if (cur->kind == T_BRANCH) {
      if (pos == n) {
        *len = cur->value_len;
        return cur->value;
      }
      cur = cur->kids[nib[pos]];
      pos++;
      continue;
    }
    gpanic("get on bad node", 47);
  }
  return 0;
}

/* -- insert ----------------------------------------------------------------

   Recursive structural insert; marks every node on the path dirty. */

static uint32_t common_prefix(const uint8_t *a, uint32_t an,
                              const uint8_t *b, uint32_t bn) {
  uint32_t i = 0, m = an < bn ? an : bn;
  while (i < m && a[i] == b[i]) i++;
  return i;
}

static tnode *insert_at(tnode *cur, const uint8_t *nib, uint32_t n,
                        const uint8_t *val, uint32_t vlen);

static tnode *make_leaf(const uint8_t *nib, uint32_t n, const uint8_t *val,
                        uint32_t vlen) {
  tnode *l = nnew(T_LEAF);
  l->path = nib_dup(nib, n);
  l->path_len = n;
  l->value = nib_dup(val, vlen);
  l->value_len = vlen;
  return l;
}

static tnode *make_ext(const uint8_t *nib, uint32_t n, tnode *child) {
  tnode *e;
  if (n == 0) return child;
  e = nnew(T_EXT);
  e->path = nib_dup(nib, n);
  e->path_len = n;
  e->child = child;
  return e;
}

static tnode *insert_at(tnode *cur, const uint8_t *nib, uint32_t n,
                        const uint8_t *val, uint32_t vlen) {
  if (cur == 0) return make_leaf(nib, n, val, vlen);
  cur = resolve(cur);
  cur->dirty = 1;
  if (cur->kind == T_LEAF) {
    uint32_t cp = common_prefix(cur->path, cur->path_len, nib, n);
    if (cp == cur->path_len && cp == n) {
      cur->value = nib_dup(val, vlen);
      cur->value_len = vlen;
      return cur;
    }
    {
      tnode *b = nnew(T_BRANCH);
      /* old leaf remainder */
      if (cur->path_len == cp) {
        b->value = cur->value;
        b->value_len = cur->value_len;
      } else {
        b->kids[cur->path[cp]] =
            make_leaf(cur->path + cp + 1, cur->path_len - cp - 1,
                      cur->value, cur->value_len);
      }
      if (n == cp) {
        b->value = nib_dup(val, vlen);
        b->value_len = vlen;
      } else {
        b->kids[nib[cp]] = make_leaf(nib + cp + 1, n - cp - 1, val, vlen);
      }
      return make_ext(nib, cp, b);
    }
  }
  if (cur->kind == T_EXT) {
    uint32_t cp = common_prefix(cur->path, cur->path_len, nib, n);
    if (cp == cur->path_len) {
      cur->child = insert_at(cur->child, nib + cp, n - cp, val, vlen);
      return cur;
    }
    {
      tnode *b = nnew(T_BRANCH);
      b->kids[cur->path[cp]] =
          make_ext(cur->path + cp + 1, cur->path_len - cp - 1, cur->child);
      if (n == cp) {
        b->value = nib_dup(val, vlen);
        b->value_len = vlen;
      } else {
        b->kids[nib[cp]] = make_leaf(nib + cp + 1, n - cp - 1, val, vlen);
      }
      return make_ext(nib, cp, b);
    }
  }
  if (cur->kind == T_BRANCH) {
    if (n == 0) {
      cur->value = nib_dup(val, vlen);
      cur->value_len = vlen;
      return cur;
    }
    cur->kids[nib[0]] = insert_at(cur->kids[nib[0]], nib + 1, n - 1,
                                  val, vlen);
    return cur;
  }
  gpanic("insert on bad node", 48);
  return 0;
}

void trie_insert(trie_t *t, const uint8_t *key, uint32_t key_len,
                 const uint8_t *value, uint32_t value_len) {
  uint8_t *nib = to_nibbles(key, key_len);
  t->root = insert_at(t->root, nib, key_len * 2, value, value_len);
}

/* -- delete ----------------------------------------------------------------

   Standard MPT removal with collapse fixups. Returns the new subtree. */

static tnode *fix_branch(tnode *b);

static tnode *delete_at(tnode *cur, const uint8_t *nib, uint32_t n,
                        uint32_t *deleted) {
  if (cur == 0) { *deleted = 0; return 0; }
  cur = resolve(cur);
  if (cur->kind == T_LEAF) {
    if (cur->path_len == n && memcmp(cur->path, nib, n) == 0) {
      *deleted = 1;
      return 0;
    }
    *deleted = 0;
    return cur;
  }
  if (cur->kind == T_EXT) {
    if (n < cur->path_len || memcmp(cur->path, nib, cur->path_len) != 0) {
      *deleted = 0;
      return cur;
    }
    {
      tnode *nc = delete_at(cur->child, nib + cur->path_len,
                            n - cur->path_len, deleted);
      if (!*deleted) return cur;
      cur->dirty = 1;
      if (nc == 0) return 0;
      nc = resolve(nc);
      if (nc->kind == T_EXT) {
        /* merge ext->ext */
        uint8_t *p = (uint8_t *)gmalloc(cur->path_len + nc->path_len);
        memcpy(p, cur->path, cur->path_len);
        memcpy(p + cur->path_len, nc->path, nc->path_len);
        nc->path = p;
        nc->path_len += cur->path_len;
        nc->dirty = 1;
        return nc;
      }
      if (nc->kind == T_LEAF) {
        uint8_t *p = (uint8_t *)gmalloc(cur->path_len + nc->path_len);
        memcpy(p, cur->path, cur->path_len);
        memcpy(p + cur->path_len, nc->path, nc->path_len);
        nc->path = p;
        nc->path_len += cur->path_len;
        nc->dirty = 1;
        return nc;
      }
      cur->child = nc;
      return cur;
    }
  }
  if (cur->kind == T_BRANCH) {
    if (n == 0) {
      if (cur->value == 0) { *deleted = 0; return cur; }
      *deleted = 1;
      cur->dirty = 1;
      cur->value = 0;
      cur->value_len = 0;
      return fix_branch(cur);
    }
    {
      uint32_t k = nib[0];
      tnode *nc = delete_at(cur->kids[k], nib + 1, n - 1, deleted);
      if (!*deleted) return cur;
      cur->dirty = 1;
      cur->kids[k] = nc;
      return fix_branch(cur);
    }
  }
  *deleted = 0;
  return cur;
}

/* collapse a branch with <2 remaining entries */
static tnode *fix_branch(tnode *b) {
  uint32_t cnt = 0, only = 16, i;
  for (i = 0; i < 16; i++)
    if (b->kids[i]) { cnt++; only = i; }
  if (cnt >= 2 || (cnt == 1 && b->value)) return b;
  if (cnt == 0) {
    if (b->value == 0) return 0;
    {
      tnode *l = nnew(T_LEAF);
      l->path = (uint8_t *)gmalloc(1);
      l->path_len = 0;
      l->value = b->value;
      l->value_len = b->value_len;
      return l;
    }
  }
  if (b->value) return b;        /* cnt==1 with value handled above */
  {
    tnode *c = resolve(b->kids[only]);
    uint8_t on = (uint8_t)only;
    if (c->kind == T_LEAF || c->kind == T_EXT) {
      uint8_t *p = (uint8_t *)gmalloc(1 + c->path_len);
      p[0] = on;
      memcpy(p + 1, c->path, c->path_len);
      c->path = p;
      c->path_len += 1;
      c->dirty = 1;
      return c;
    }
    /* child is a branch: new 1-nibble extension */
    {
      tnode *e = nnew(T_EXT);
      e->path = (uint8_t *)gmalloc(1);
      e->path[0] = on;
      e->path_len = 1;
      e->child = c;
      return e;
    }
  }
}

void trie_delete(trie_t *t, const uint8_t *key, uint32_t key_len) {
  uint8_t *nib = to_nibbles(key, key_len);
  uint32_t deleted = 0;
  t->root = delete_at(t->root, nib, key_len * 2, &deleted);
}

/* -- hashing ----------------------------------------------------------------

   Post-order encode; nodes < 32 bytes embed raw, else keccak digest.
   enc/enc_len cache cleans the tree as it goes. */

static void node_ref(tnode *n, rlpw_t *w);

/* worst-case encoding size (leaf values — e.g. receipts — can be large,
 * so buffers are bump-allocated per node, exact upper bound) */
static uint32_t enc_bound(const tnode *n) {
  if (n->kind == T_BRANCH) return 16 * 33 + n->value_len + 12;
  return n->path_len / 2 + 2 + n->value_len + 33 + 12;
}

static uint8_t *encode_node(tnode *n, uint32_t *out_len) {
  rlpw_t w;
  uint32_t mark;
  uint8_t *out = (uint8_t *)gmalloc(enc_bound(n));
  rlpw_init(&w, out, enc_bound(n));
  mark = rlpw_list_begin(&w);
  if (n->kind == T_LEAF || n->kind == T_EXT) {
    uint8_t hp[40];
    uint32_t hn = hp_encode(n->path, n->path_len, n->kind == T_LEAF, hp);
    rlpw_bytes(&w, hp, hn);
    if (n->kind == T_LEAF) {
      rlpw_bytes(&w, n->value, n->value_len);
    } else {
      node_ref(n->child, &w);
    }
  } else if (n->kind == T_BRANCH) {
    uint32_t i;
    for (i = 0; i < 16; i++) {
      if (n->kids[i] == 0) {
        rlpw_bytes(&w, 0, 0);
      } else {
        node_ref(n->kids[i], &w);
      }
    }
    rlpw_bytes(&w, n->value, n->value_len);
  } else {
    gpanic("encode bad node", 49);
  }
  rlpw_list_end(&w, mark);
  if (rlpw_overflowed(&w)) gpanic("node too big", 50);
  *out_len = w.len;
  return out;
}

/* write a child reference (embedded raw if <32, else 32B hash string) */
static void node_ref(tnode *n, rlpw_t *w) {
  if (n->kind == T_HASHREF || !n->dirty) {
    if (n->enc_len == 32) {
      rlpw_bytes(w, n->enc, 32);
    } else {
      rlpw_raw(w, n->enc, n->enc_len);
    }
    return;
  }
  {
    uint32_t blen;
    uint8_t *buf = encode_node(n, &blen);
    if (blen < 32) {
      memcpy(n->enc, buf, blen);
      n->enc_len = (uint8_t)blen;
      n->dirty = 0;
      rlpw_raw(w, buf, blen);
    } else {
      keccak256(buf, blen, n->enc);
      n->enc_len = 32;
      n->dirty = 0;
      rlpw_bytes(w, n->enc, 32);
    }
  }
}

void trie_root(trie_t *t, uint8_t out[32]) {
  uint32_t blen;
  uint8_t *buf;
  tnode *r = t->root;
  if (r == 0) {
    memcpy(out, TRIE_EMPTY_ROOT, 32);
    return;
  }
  if (r->kind == T_HASHREF || !r->dirty) {
    if (r->enc_len == 32) {
      memcpy(out, r->enc, 32);
      return;
    }
    keccak256(r->enc, r->enc_len, out);
    return;
  }
  buf = encode_node(r, &blen);
  if (blen < 32) {
    memcpy(r->enc, buf, blen);
    r->enc_len = (uint8_t)blen;
  }
  r->dirty = 0;
  keccak256(buf, blen, out);
  if (blen >= 32) {
    memcpy(r->enc, out, 32);
    r->enc_len = 32;
  }
}
