/* RLP for the guest: zero-copy decoder + append encoder.
 *
 * The in-guest role of alloy-rlp (SURVEY.md §2.2 reth-stateless stack):
 * decodes witness trie nodes, headers and transactions; encodes trie
 * nodes, accounts and receipts for hashing. List closing moves the
 * payload when the header is longer than 1 byte (headers are <= 4B).
 */
#include <stdint.h>
#include <string.h>
#include <rlp.h>

uint32_t rlp_parse(const uint8_t *p, const uint8_t *end, rlp_t *out) {
  uint32_t b, n, i, ll;
  if (p >= end) return 0;
  b = p[0];
  out->raw = p;
  if (b < 0x80) {
    out->p = p;
    out->len = 1;
    out->is_list = 0;
    out->raw_len = 1;
    return 1;
  }
  if (b < 0xB8) {               /* short string */
    n = b - 0x80;
    if (p + 1 + n > end) return 0;
    out->p = p + 1;
    out->len = n;
    out->is_list = 0;
    out->raw_len = 1 + n;
    return 1;
  }
  if (b < 0xC0) {               /* long string */
    ll = b - 0xB7;
    if (ll > 4 || p + 1 + ll > end) return 0;
    n = 0;
    for (i = 0; i < ll; i++) n = (n << 8) | p[1 + i];
    if (p + 1 + ll + n > end || (uint32_t)(end - p) < 1 + ll + n) return 0;
    out->p = p + 1 + ll;
    out->len = n;
    out->is_list = 0;
    out->raw_len = 1 + ll + n;
    return 1;
  }
  if (b < 0xF8) {               /* short list */
    n = b - 0xC0;
    if (p + 1 + n > end) return 0;
    out->p = p + 1;
    out->len = n;
    out->is_list = 1;
    out->raw_len = 1 + n;
    return 1;
  }
  ll = b - 0xF7;                /* long list */
  if (ll > 4 || p + 1 + ll > end) return 0;
  n = 0;
  for (i = 0; i < ll; i++) n = (n << 8) | p[1 + i];
  if ((uint32_t)(end - p) < 1 + ll + n) return 0;
  out->p = p + 1 + ll;
  out->len = n;
  out->is_list = 1;
  out->raw_len = 1 + ll + n;
  return 1;
}

uint32_t rlp_next(const rlp_t *list, const uint8_t **cur, rlp_t *out) {
  const uint8_t *end = list->p + list->len;
  if (*cur == 0) *cur = list->p;
  if (*cur >= end) return 0;
  if (!rlp_parse(*cur, end, out)) return 0;
  *cur += out->raw_len;
  return 1;
}

uint32_t rlp_count(const rlp_t *list) {
  const uint8_t *cur = 0;
  rlp_t it;
  uint32_t n = 0;
  while (rlp_next(list, &cur, &it)) n++;
  return n;
}

uint32_t rlp_at(const rlp_t *list, uint32_t idx, rlp_t *out) {
  const uint8_t *cur = 0;
  uint32_t i;
  for (i = 0; i <= idx; i++)
    if (!rlp_next(list, &cur, out)) return 0;
  return 1;
}

void rlp_u256(const rlp_t *item, u256 *out) {
  u256_from_be_n(out, item->p, item->len);
}

uint32_t rlp_u32(const rlp_t *item) {
  uint32_t v = 0, i;
  for (i = 0; i < item->len && i < 4; i++) v = (v << 8) | item->p[i];
  return v;
}

/* -- encoder ------------------------------------------------------------ */

void rlpw_init(rlpw_t *w, uint8_t *buf, uint32_t cap) {
  w->buf = buf;
  w->len = 0;
  w->cap = cap;
}

uint32_t rlpw_overflowed(const rlpw_t *w) { return w->len > w->cap; }

static void put(rlpw_t *w, uint8_t b) {
  if (w->len < w->cap) w->buf[w->len] = b;
  w->len++;
}

static void put_n(rlpw_t *w, const uint8_t *p, uint32_t n) {
  if (w->len + n <= w->cap) memcpy(w->buf + w->len, p, n);
  w->len += n;
}

static void put_len(rlpw_t *w, uint32_t n, uint8_t base) {
  if (n < 56) {
    put(w, (uint8_t)(base + n));
  } else if (n < 0x100) {
    put(w, base + 55 + 1);
    put(w, (uint8_t)n);
  } else if (n < 0x10000) {
    put(w, base + 55 + 2);
    put(w, (uint8_t)(n >> 8));
    put(w, (uint8_t)n);
  } else {
    put(w, base + 55 + 3);
    put(w, (uint8_t)(n >> 16));
    put(w, (uint8_t)(n >> 8));
    put(w, (uint8_t)n);
  }
}

void rlpw_bytes(rlpw_t *w, const uint8_t *p, uint32_t n) {
  if (n == 1 && p[0] < 0x80) {
    put(w, p[0]);
    return;
  }
  put_len(w, n, 0x80);
  put_n(w, p, n);
}

void rlpw_u256(rlpw_t *w, const u256 *v) {
  uint8_t buf[32];
  uint32_t n = u256_to_be_min(v, buf);
  rlpw_bytes(w, buf, n);
}

void rlpw_u32(rlpw_t *w, uint32_t v) {
  u256 t;
  u256_from_u32(&t, v);
  rlpw_u256(w, &t);
}

void rlpw_raw(rlpw_t *w, const uint8_t *p, uint32_t n) { put_n(w, p, n); }

uint32_t rlpw_list_begin(rlpw_t *w) {
  w->len += 4;                  /* reserve worst-case header */
  return w->len;
}

void rlpw_list_end(rlpw_t *w, uint32_t mark) {
  uint32_t payload = w->len - mark;
  uint32_t hdr;
  uint8_t h[4];
  rlpw_t hw;
  hw.buf = h;
  hw.len = 0;
  hw.cap = 4;
  put_len(&hw, payload, 0xC0);
  hdr = hw.len;
  if (w->len <= w->cap) {
    /* move payload left so the header is contiguous */
    memcpy(w->buf + mark - 4, h, hdr);
    if (hdr < 4)
      memmove(w->buf + mark - 4 + hdr, w->buf + mark, payload);
  }
  w->len = mark - 4 + hdr + payload;
}
