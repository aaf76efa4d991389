/* The stateless-client guest: the program whose execution is proven.
 *
 * In-zkVM port of the reference guest (SURVEY.md §2.1
 * guests/stateless-client/src/lib.rs:21-34): read the StatelessInput,
 * validate the block by full re-execution (the semantics of the host's
 * app/host.py validate_block + execute_block), and commit the 32-byte
 * block hash to the journal (lib.rs:33 env::commit_slice).
 *
 * Input (word-aligned, little-endian u32 framing; produced by
 * zeth_tpu_torch/app/guest_input.py):
 *   [total_len]
 *   [chain_id]
 *   [header_len][header_rlp pad4]
 *   [n_ancestors]{[len][rlp pad4]}       parent first
 *   [n_txs]{[len][envelope pad4]}
 *   [n_withdrawals]{addr(20) amount_gwei_be(12)}
 *   [n_state_nodes]{[len][bytes pad4]}
 *   [n_codes]{[len][bytes pad4]}
 */
#include <stdint.h>
#include <string.h>
#include <alloc.h>
#include <zeth.h>
#include <keccak.h>
#include <rlp.h>
#include <u256.h>
#include <trie.h>
#include <gstate.h>
#include <gevm.h>
#include <gtx.h>

#define GAS_PER_BLOB 131072u
#define BLOB_FEE_FRACTION 3338477u          /* Cancun (EIP-4844) */
#define BLOB_FEE_FRACTION_PRAGUE 5007716u   /* Prague (EIP-7691) */

static const uint8_t BEACON_ROOTS[20] = {
  0x00, 0x0F, 0x3d, 0xf6, 0xd7, 0x32, 0x80, 0x7e, 0xf1, 0x31,
  0x9f, 0xb7, 0xb8, 0xbb, 0x85, 0x22, 0xd0, 0xbe, 0xac, 0x02};
/* EIP-2935 block-hash history contract */
static const uint8_t HISTORY_STORAGE[20] = {
  0x00, 0x00, 0xF9, 0x08, 0x27, 0xf1, 0xc5, 0x3a, 0x10, 0xcb,
  0x7a, 0x02, 0x33, 0x5b, 0x17, 0x53, 0x20, 0x00, 0x29, 0x35};
/* EIP-7002 withdrawal-requests contract */
static const uint8_t WITHDRAWAL_REQUESTS[20] = {
  0x00, 0x00, 0x09, 0x61, 0xEf, 0x48, 0x0E, 0xb5, 0x5e, 0x80,
  0xD1, 0x9a, 0xd8, 0x35, 0x79, 0xA6, 0x4c, 0x00, 0x70, 0x02};
/* EIP-7251 consolidation-requests contract */
static const uint8_t CONSOLIDATION_REQUESTS[20] = {
  0x00, 0x00, 0xBB, 0xdD, 0xc7, 0xCE, 0x48, 0x86, 0x42, 0xfb,
  0x57, 0x9F, 0x8B, 0x00, 0xf3, 0xa5, 0x90, 0x00, 0x72, 0x51};
/* keccak("DepositEvent(bytes,bytes,bytes,bytes,bytes)") (EIP-6110) */
static const uint8_t DEPOSIT_TOPIC[32] = {
  0x64, 0x9b, 0xbc, 0x62, 0xd0, 0xe3, 0x13, 0x42, 0xaf, 0xea, 0x4e,
  0x5c, 0xd8, 0x2d, 0x40, 0x49, 0xe7, 0xe1, 0xee, 0x91, 0x2f, 0xc0,
  0x88, 0x9a, 0xa7, 0x90, 0x80, 0x3b, 0xe3, 0x90, 0x38, 0xc5};

/* Compiled-in chain specification (the reference embeds zeth-chainspec
 * per guest binary — crates/chainspec/src/lib.rs:40-80; mirroring
 * app/chainspec.py). Prague activation timestamps + deposit contracts. */
typedef struct {
  uint32_t chain_id;
  uint32_t prague_ts;
  uint8_t deposit_contract[20];
} gspec;

static const gspec SPECS[4] = {
  {1u, 1746612311u,
   {0x00, 0x00, 0x00, 0x00, 0x21, 0x9a, 0xb5, 0x40, 0x35, 0x6c,
    0xbb, 0x83, 0x9c, 0xbe, 0x05, 0x30, 0x3d, 0x77, 0x05, 0xfa}},
  {11155111u, 1741159776u,
   {0x7f, 0x02, 0xc3, 0xe3, 0xc9, 0x8b, 0x13, 0x30, 0x55, 0xb8,
    0xb3, 0x48, 0xb2, 0xac, 0x62, 0x56, 0x69, 0xed, 0x29, 0x5d}},
  {17000u, 1740434112u,
   {0x42, 0x42, 0x42, 0x42, 0x42, 0x42, 0x42, 0x42, 0x42, 0x42,
    0x42, 0x42, 0x42, 0x42, 0x42, 0x42, 0x42, 0x42, 0x42, 0x42}},
  {560048u, 1742999832u,
   {0x00, 0x00, 0x00, 0x00, 0x21, 0x9a, 0xb5, 0x40, 0x35, 0x6c,
    0xbb, 0x83, 0x9c, 0xbe, 0x05, 0x30, 0x3d, 0x77, 0x05, 0xfa}}};

static const gspec *spec_of(uint32_t chain_id) {
  uint32_t i;
  for (i = 0; i < 4; i++)
    if (SPECS[i].chain_id == chain_id) return &SPECS[i];
  gpanic("unsupported chain id", 145);
  return 0;
}

typedef struct {
  const uint8_t *raw;
  uint32_t raw_len;
  uint8_t hash[32];
  uint8_t parent_hash[32];
  uint8_t beneficiary[20];
  uint8_t state_root[32];
  uint8_t tx_root[32];
  uint8_t receipts_root[32];
  const uint8_t *bloom;
  u256 difficulty;
  uint32_t number;
  uint32_t gas_limit;
  uint32_t gas_used;
  uint32_t timestamp;
  u256 mix_hash;
  uint32_t n_items;
  u256 base_fee;
  uint32_t has_blob;
  uint32_t blob_gas_used;
  u256 excess_blob_gas;
  uint32_t has_beacon_root;
  uint8_t beacon_root[32];
  uint32_t has_requests;
  uint8_t requests_hash[32];
} gheader;

static void parse_header(const uint8_t *raw, uint32_t len, gheader *h) {
  rlp_t top, it;
  memset(h, 0, sizeof(gheader));
  h->raw = raw;
  h->raw_len = len;
  keccak256(raw, len, h->hash);
  if (!rlp_parse(raw, raw + len, &top) || !top.is_list)
    gpanic("bad header rlp", 110);
  h->n_items = rlp_count(&top);
  if (h->n_items < 15) gpanic("short header", 111);
  rlp_at(&top, 0, &it);
  if (it.len != 32) gpanic("parent hash", 112);
  memcpy(h->parent_hash, it.p, 32);
  rlp_at(&top, 2, &it);
  if (it.len != 20) gpanic("beneficiary", 113);
  memcpy(h->beneficiary, it.p, 20);
  rlp_at(&top, 3, &it);
  memcpy(h->state_root, it.p, 32);
  rlp_at(&top, 4, &it);
  memcpy(h->tx_root, it.p, 32);
  rlp_at(&top, 5, &it);
  memcpy(h->receipts_root, it.p, 32);
  rlp_at(&top, 6, &it);
  if (it.len != 256) gpanic("bloom", 114);
  h->bloom = it.p;
  rlp_at(&top, 7, &it);
  rlp_u256(&it, &h->difficulty);
  rlp_at(&top, 8, &it);
  h->number = rlp_u32(&it);
  rlp_at(&top, 9, &it);
  h->gas_limit = rlp_u32(&it);
  rlp_at(&top, 10, &it);
  h->gas_used = rlp_u32(&it);
  rlp_at(&top, 11, &it);
  h->timestamp = rlp_u32(&it);
  rlp_at(&top, 13, &it);
  rlp_u256(&it, &h->mix_hash);
  if (h->n_items > 15) {
    rlp_at(&top, 15, &it);
    rlp_u256(&it, &h->base_fee);
  }
  if (h->n_items > 18) {
    h->has_blob = 1;
    rlp_at(&top, 17, &it);
    h->blob_gas_used = rlp_u32(&it);
    rlp_at(&top, 18, &it);
    rlp_u256(&it, &h->excess_blob_gas);
  }
  if (h->n_items > 19) {
    rlp_at(&top, 19, &it);
    if (it.len == 32) {
      h->has_beacon_root = 1;
      memcpy(h->beacon_root, it.p, 32);
    }
  }
  if (h->n_items > 20) {
    rlp_at(&top, 20, &it);
    if (it.len == 32) {
      h->has_requests = 1;
      memcpy(h->requests_hash, it.p, 32);
    }
  }
}

/* EIP-4844 blob base fee: fake_exponential(1, excess, fraction) —
 * the update fraction is fork-dependent (Prague = EIP-7691) */
static void blob_base_fee(const u256 *excess, uint32_t fraction, u256 *out) {
  u256 acc, output, denom, i_u, t;
  uint32_t i = 1;
  u256_from_u32(&denom, fraction);
  acc = denom;                      /* factor = 1 */
  u256_zero(&output);
  while (!u256_is_zero(&acc)) {
    u256_add(&output, &output, &acc);
    u256_mul(&t, &acc, excess);
    u256_from_u32(&i_u, i);
    u256_mul(&i_u, &i_u, &denom);
    u256_div(&acc, &t, &i_u);
    i++;
    if (i > 10000) gpanic("blob fee diverged", 115);
  }
  u256_div(out, &output, &denom);
}

/* -- logs bloom ------------------------------------------------------------ */

static void bloom_add(uint8_t bloom[256], const uint8_t *item,
                      uint32_t len) {
  uint8_t h[32];
  uint32_t i;
  keccak256(item, len, h);
  for (i = 0; i < 6; i += 2) {
    uint32_t bit = (((uint32_t)h[i] << 8) | h[i + 1]) & 0x7FFu;
    bloom[256 - 1 - bit / 8] |= (uint8_t)(1u << (bit % 8));
  }
}

static void bloom_logs(glog *g, uint32_t count, uint8_t bloom[256]) {
  uint32_t i, k;
  for (i = 0; i < count && g; i++, g = g->next) {
    bloom_add(bloom, g->addr, 20);
    for (k = 0; k < g->n_topics; k++) bloom_add(bloom, g->topics[k], 32);
  }
}

/* receipt = [type] || rlp([status, cumulative, bloom, logs]) */
static uint8_t *encode_receipt(uint32_t tx_type, uint32_t status,
                               uint32_t cumulative, glog *logs,
                               uint32_t n_logs, uint32_t *out_len) {
  uint32_t bound = 300 + 256;
  glog *g = logs;
  uint32_t i;
  uint8_t rbloom[256];
  for (i = 0; i < n_logs && g; i++, g = g->next)
    bound += 90 + 32 * g->n_topics + g->data_len;
  {
    uint8_t *buf = (uint8_t *)gmalloc(bound);
    rlpw_t w;
    uint32_t mark, lmark;
    rlpw_init(&w, buf + 1, bound - 1);
    mark = rlpw_list_begin(&w);
    rlpw_u32(&w, status);
    rlpw_u32(&w, cumulative);
    memset(rbloom, 0, 256);
    bloom_logs(logs, n_logs, rbloom);
    rlpw_bytes(&w, rbloom, 256);
    lmark = rlpw_list_begin(&w);
    g = logs;
    for (i = 0; i < n_logs && g; i++, g = g->next) {
      uint32_t m2 = rlpw_list_begin(&w);
      uint32_t tmark;
      uint32_t k;
      rlpw_bytes(&w, g->addr, 20);
      tmark = rlpw_list_begin(&w);
      for (k = 0; k < g->n_topics; k++)
        rlpw_bytes(&w, g->topics[k], 32);
      rlpw_list_end(&w, tmark);
      rlpw_bytes(&w, g->data, g->data_len);
      rlpw_list_end(&w, m2);
    }
    rlpw_list_end(&w, lmark);
    rlpw_list_end(&w, mark);
    if (rlpw_overflowed(&w)) gpanic("receipt overflow", 116);
    if (tx_type == 0) {
      *out_len = w.len;
      return buf + 1;
    }
    buf[0] = (uint8_t)tx_type;
    memmove(buf + 1, w.buf, w.len);
    *out_len = w.len + 1;
    return buf;
  }
}

/* log "label a b" with decimal u32s (mismatch diagnostics) */
static void log_nums(const char *label, uint32_t a, uint32_t b) {
  char buf[64];
  uint32_t i = 0, j;
  char tmp[12];
  while (label[i]) { buf[i] = label[i]; i++; }
  buf[i++] = ' ';
  j = 0;
  do { tmp[j++] = (char)('0' + a % 10); a /= 10; } while (a);
  while (j) buf[i++] = tmp[--j];
  buf[i++] = ' ';
  j = 0;
  do { tmp[j++] = (char)('0' + b % 10); b /= 10; } while (b);
  while (j) buf[i++] = tmp[--j];
  env_log(buf, i);
}

/* ordered trie key: rlp(i) */
static uint32_t index_key(uint32_t i, uint8_t out[6]) {
  rlpw_t w;
  rlpw_init(&w, out, 6);
  rlpw_u32(&w, i);
  return w.len;
}

/* -- input cursor ------------------------------------------------------------ */

static const uint8_t *in_p;

static uint32_t rd_u32(void) {
  uint32_t v = (uint32_t)in_p[0] | ((uint32_t)in_p[1] << 8)
               | ((uint32_t)in_p[2] << 16) | ((uint32_t)in_p[3] << 24);
  in_p += 4;
  return v;
}

static const uint8_t *rd_blob(uint32_t *len) {
  const uint8_t *p;
  *len = rd_u32();
  p = in_p;
  in_p += (*len + 3u) & ~3u;
  return p;
}

int main(void) {
  uint32_t total, chain_id;
  uint8_t *input;
  gheader header, parent;
  uint32_t n_anc, n_txs, n_wd, n_nodes, n_codes;
  const uint8_t **anc_raw;
  uint32_t *anc_len;
  uint8_t *anc_hashes;
  const uint8_t **tx_raw;
  uint32_t *tx_len;
  const uint8_t *withdrawals;
  u256 bbf;
  uint32_t i;
  const gspec *spec;
  uint8_t *deposits = 0;
  uint32_t deposits_len = 0, deposits_cap = 0;

  {
    uint32_t hdr[1];
    if (env_read(hdr, 4) != 4) gpanic("no input", 120);
    total = hdr[0];
  }
  input = (uint8_t *)gmalloc((total + 3u) & ~3u);
  if (env_read(input, (total + 3u) & ~3u) < total) gpanic("short input", 121);
  in_p = input;

  chain_id = rd_u32();
  {
    uint32_t hlen;
    const uint8_t *hraw = rd_blob(&hlen);
    parse_header(hraw, hlen, &header);
  }
  if (!u256_is_zero(&header.difficulty))
    gpanic("pre-merge blocks are not supported", 122);

  /* ancestors (parent first) */
  n_anc = rd_u32();
  if (n_anc == 0) gpanic("witness has no ancestor headers", 123);
  anc_raw = (const uint8_t **)gmalloc(n_anc * 4);
  anc_len = (uint32_t *)gmalloc(n_anc * 4);
  anc_hashes = (uint8_t *)gmalloc(32 * n_anc);
  for (i = 0; i < n_anc; i++)
    anc_raw[i] = rd_blob(&anc_len[i]);
  parse_header(anc_raw[0], anc_len[0], &parent);
  if (memcmp(parent.hash, header.parent_hash, 32) != 0)
    gpanic("parent header does not match parent_hash", 124);
  if (parent.number + 1 != header.number)
    gpanic("parent number mismatch", 125);
  memcpy(anc_hashes, parent.hash, 32);
  {
    gheader prev = parent;
    for (i = 1; i < n_anc; i++) {
      gheader h;
      parse_header(anc_raw[i], anc_len[i], &h);
      if (memcmp(h.hash, prev.parent_hash, 32) != 0)
        gpanic("broken ancestor header chain", 126);
      memcpy(anc_hashes + 32 * i, h.hash, 32);
      prev = h;
    }
  }

  /* transactions */
  n_txs = rd_u32();
  tx_raw = (const uint8_t **)gmalloc(n_txs ? n_txs * 4 : 4);
  tx_len = (uint32_t *)gmalloc(n_txs ? n_txs * 4 : 4);
  for (i = 0; i < n_txs; i++)
    tx_raw[i] = rd_blob(&tx_len[i]);

  n_wd = rd_u32();
  withdrawals = in_p;
  in_p += 32 * n_wd;

  /* witness */
  n_nodes = rd_u32();
  {
    uint32_t cap = 1024;
    while (cap < 2 * n_nodes + 16) cap *= 2;
    store_init(cap);
  }
  for (i = 0; i < n_nodes; i++) {
    uint32_t len;
    const uint8_t *node = rd_blob(&len);
    store_add(node, len);
  }
  n_codes = rd_u32();
  for (i = 0; i < n_codes; i++) {
    uint32_t len;
    const uint8_t *code = rd_blob(&len);
    gs_add_code(code, len);
  }
  if ((uint32_t)(in_p - input) > total) gpanic("input framing", 127);

  /* pre-state trie hydrates at the parent state root */
  if (n_nodes) {
    uint32_t rl;
    if (store_get(parent.state_root, &rl) == 0)
      gpanic("witness is missing the state root node", 128);
  }
  gs_init(parent.state_root);

  /* transactions root */
  {
    trie_t txt;
    uint8_t root[32];
    txt.root = 0;
    for (i = 0; i < n_txs; i++) {
      uint8_t key[6];
      uint32_t klen = index_key(i, key);
      trie_insert(&txt, key, klen, tx_raw[i], tx_len[i]);
    }
    trie_root(&txt, root);
    if (memcmp(root, header.tx_root, 32) != 0)
      gpanic("transactions root mismatch", 129);
  }

  /* environment */
  memset(&ENV, 0, sizeof(ENV));
  memcpy(ENV.coinbase, header.beneficiary, 20);
  ENV.number = header.number;
  ENV.timestamp = header.timestamp;
  ENV.gas_limit = header.gas_limit;
  ENV.chain_id = chain_id;
  ENV.basefee = header.base_fee;
  ENV.prevrandao = header.mix_hash;
  ENV.n_ancestors = n_anc;
  ENV.ancestor_first = parent.number;
  ENV.ancestor_hashes = anc_hashes;
  spec = spec_of(chain_id);
  ENV.is_prague = header.timestamp >= spec->prague_ts;
  if (ENV.is_prague != header.has_requests)
    gpanic("requests_hash does not match the active fork", 146);
  u256_zero(&bbf);
  if (header.has_blob)
    blob_base_fee(&header.excess_blob_gas,
                  ENV.is_prague ? BLOB_FEE_FRACTION_PRAGUE
                                : BLOB_FEE_FRACTION, &bbf);
  ENV.blob_basefee = bbf;

  if (header.has_beacon_root)
    gevm_system_call(BEACON_ROOTS, header.beacon_root, 32);
  if (ENV.is_prague)
    gevm_system_call(HISTORY_STORAGE, header.parent_hash, 32);

  /* execute every transaction */
  {
    trie_t rct;
    uint8_t block_bloom[256];
    uint32_t cumulative = 0, blob_gas_total = 0;
    rct.root = 0;
    memset(block_bloom, 0, 256);
    for (i = 0; i < n_txs; i++) {
      gtx tx;
      uint8_t sender[20];
      u256 eff, tip, blob_fee;
      uint32_t used = 0;
      int rc;
      gtx_parse(tx_raw[i], tx_len[i], &tx);
      gtx_sender(&tx, sender);
      gtx_effective_price(&tx, &ENV.basefee, &eff, &tip);
      u256_zero(&blob_fee);
      if (tx.type == 3) {
        u256 t;
        u256_from_u32(&t, tx.n_blobs * GAS_PER_BLOB);
        u256_mul(&blob_fee, &t, &bbf);
        blob_gas_total += tx.n_blobs * GAS_PER_BLOB;
      }
      {
        txctx c;
        memset(&c, 0, sizeof(c));
        memcpy(c.from, sender, 20);
        c.to = tx.has_to ? tx.to : 0;
        c.value = tx.value;
        c.gas_limit = tx.gas_limit;
        c.eff_gas_price = eff;
        c.tip_per_gas = tip;
        c.data = tx.data;
        c.data_len = tx.data_len;
        c.access_list = tx.acl;
        c.acl_len = tx.acl_len;
        c.blob_hashes = tx.blob_hashes;
        c.n_blobs = tx.n_blobs;
        c.blob_fee = blob_fee;
        c.tx_nonce = tx.nonce;
        c.auth_rlp = tx.auth_rlp;
        c.auth_rlp_len = tx.auth_rlp_len;
        c.n_auth = tx.n_auth;
        rc = gevm_exec_tx(&c, &used);
      }
      if (rc < 0) gpanic("invalid transaction", 130);
      cumulative += used;
      {
        glog *logs;
        uint32_t n_logs, rlen;
        uint8_t *receipt;
        uint8_t key[6];
        uint32_t klen = index_key(i, key);
        logs = gs_tx_logs(&n_logs);
        receipt = encode_receipt(tx.type, rc == 1 ? 1 : 0, cumulative,
                                 logs, n_logs, &rlen);
        trie_insert(&rct, key, klen, receipt, rlen);
        bloom_logs(logs, n_logs, block_bloom);
        /* EIP-6110: collect deposit requests from the deposit
         * contract's DepositEvent logs (strict ABI layout check) */
        if (ENV.is_prague) {
          glog *g = logs;
          uint32_t li;
          for (li = 0; li < n_logs && g; li++, g = g->next) {
            uint32_t f;
            static const uint32_t DL_OFF[5] = {160, 256, 320, 384, 512};
            static const uint32_t DL_LEN[5] = {48, 32, 8, 96, 8};
            if (memcmp(g->addr, spec->deposit_contract, 20) != 0)
              continue;
            if (g->n_topics == 0
                || memcmp(g->topics[0], DEPOSIT_TOPIC, 32) != 0)
              continue;
            if (g->data_len != 576)
              gpanic("malformed DepositEvent data", 147);
            for (f = 0; f < 5; f++) {
              const uint8_t *w = g->data + 32 * f;
              uint32_t v = ((uint32_t)w[28] << 24) | ((uint32_t)w[29] << 16)
                           | ((uint32_t)w[30] << 8) | w[31];
              uint32_t k2;
              for (k2 = 0; k2 < 28; k2++)
                if (w[k2]) gpanic("malformed DepositEvent offsets", 148);
              if (v != DL_OFF[f])
                gpanic("malformed DepositEvent offsets", 148);
              w = g->data + DL_OFF[f];
              v = ((uint32_t)w[28] << 24) | ((uint32_t)w[29] << 16)
                  | ((uint32_t)w[30] << 8) | w[31];
              for (k2 = 0; k2 < 28; k2++)
                if (w[k2]) gpanic("malformed DepositEvent length", 149);
              if (v != DL_LEN[f])
                gpanic("malformed DepositEvent length", 149);
              if (deposits_len + DL_LEN[f] + 1 > deposits_cap) {
                uint32_t ncap = deposits_cap ? deposits_cap * 2 : 1024;
                uint8_t *nb;
                while (ncap < deposits_len + DL_LEN[f] + 1) ncap *= 2;
                nb = (uint8_t *)gmalloc(ncap);
                if (deposits_len) memcpy(nb, deposits, deposits_len);
                else nb[0] = 0x00;            /* request type byte */
                deposits = nb;
                deposits_cap = ncap;
              }
              if (deposits_len == 0) {
                deposits[0] = 0x00;
                deposits_len = 1;
              }
              memcpy(deposits + deposits_len, g->data + DL_OFF[f] + 32,
                     DL_LEN[f]);
              deposits_len += DL_LEN[f];
            }
          }
        }
      }
    }

    /* withdrawals (gwei amounts) */
    for (i = 0; i < n_wd; i++) {
      const uint8_t *w = withdrawals + 32 * i;
      u256 amount, gwei, nb;
      u256_from_be_n(&amount, w + 20, 12);
      if (!u256_is_zero(&amount)) {
        gacct *a = gs_account(w);
        u256_from_u32(&gwei, 1000000000u);
        u256_mul(&amount, &amount, &gwei);
        if (!a->exists) a->exists = 1;
        u256_add(&nb, &a->balance, &amount);
        a->balance = nb;
      }
    }

    /* EIP-7685 requests hash (Prague): sha256 over sha256(type || data)
     * of each non-empty request — deposits from logs, then the
     * EIP-7002/7251 system-call queues */
    if (ENV.is_prague) {
      uint8_t acc[96];
      uint32_t acc_len = 0;
      uint8_t rh[32];
      if (deposits_len > 1) {
        sha256(deposits, deposits_len, acc + acc_len);
        acc_len += 32;
      }
      {
        uint8_t *qout;
        int qn = gevm_system_call_out(WITHDRAWAL_REQUESTS, 0, 0, &qout);
        if (qn < 0) gpanic("EIP-7002 contract missing", 150);
        if (qn > 0) {
          uint8_t *buf = (uint8_t *)gmalloc((uint32_t)qn + 1);
          buf[0] = 0x01;
          memcpy(buf + 1, qout, (uint32_t)qn);
          sha256(buf, (uint32_t)qn + 1, acc + acc_len);
          acc_len += 32;
        }
        qn = gevm_system_call_out(CONSOLIDATION_REQUESTS, 0, 0, &qout);
        if (qn < 0) gpanic("EIP-7251 contract missing", 151);
        if (qn > 0) {
          uint8_t *buf = (uint8_t *)gmalloc((uint32_t)qn + 1);
          buf[0] = 0x02;
          memcpy(buf + 1, qout, (uint32_t)qn);
          sha256(buf, (uint32_t)qn + 1, acc + acc_len);
          acc_len += 32;
        }
      }
      sha256(acc, acc_len, rh);
      if (memcmp(rh, header.requests_hash, 32) != 0)
        gpanic("requests hash mismatch", 152);
    }

    /* post-execution header commitments */
    if (cumulative != header.gas_used) {
      log_nums("gas got/want:", cumulative, header.gas_used);
      gpanic("gas used mismatch", 131);
    }
    if (header.has_blob && blob_gas_total != header.blob_gas_used)
      gpanic("blob gas used mismatch", 132);
    {
      uint8_t root[32];
      trie_root(&rct, root);
      if (memcmp(root, header.receipts_root, 32) != 0)
        gpanic("receipts root mismatch", 133);
    }
    if (memcmp(block_bloom, header.bloom, 256) != 0)
      gpanic("logs bloom mismatch", 134);
    {
      uint8_t post[32];
      gs_post_root(post);
      if (memcmp(post, header.state_root, 32) != 0)
        gpanic("post-state root mismatch", 135);
    }
  }

  env_commit(header.hash, 32);
  return 0;
}
