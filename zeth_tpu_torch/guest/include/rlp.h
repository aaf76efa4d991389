#ifndef _G_RLP_H
#define _G_RLP_H
#include <stdint.h>
#include <u256.h>

/* -- decoder: zero-copy views over an input buffer ---------------------- */

typedef struct {
  const uint8_t *p;   /* payload start */
  uint32_t len;       /* payload length */
  uint32_t is_list;
  const uint8_t *raw; /* whole item incl. header */
  uint32_t raw_len;
} rlp_t;

/* parse the item at p (bounded by end); returns 0 on malformed input */
uint32_t rlp_parse(const uint8_t *p, const uint8_t *end, rlp_t *out);
/* iterate list payload: *cur advances; returns 0 when exhausted/bad */
uint32_t rlp_next(const rlp_t *list, const uint8_t **cur, rlp_t *out);
/* item count of a list (validates framing) */
uint32_t rlp_count(const rlp_t *list);
/* nth element (linear scan); returns 0 on out-of-range */
uint32_t rlp_at(const rlp_t *list, uint32_t idx, rlp_t *out);
/* scalar decode (big-endian quantity) */
void rlp_u256(const rlp_t *item, u256 *out);
uint32_t rlp_u32(const rlp_t *item);

/* -- encoder: append into a caller buffer ------------------------------- */

typedef struct {
  uint8_t *buf;
  uint32_t len;
  uint32_t cap;
} rlpw_t;

void rlpw_init(rlpw_t *w, uint8_t *buf, uint32_t cap);
void rlpw_bytes(rlpw_t *w, const uint8_t *p, uint32_t n);   /* string item */
void rlpw_u256(rlpw_t *w, const u256 *v);                    /* quantity */
void rlpw_u32(rlpw_t *w, uint32_t v);
void rlpw_raw(rlpw_t *w, const uint8_t *p, uint32_t n);      /* pre-encoded */
/* list: reserve header, write payload, then close */
uint32_t rlpw_list_begin(rlpw_t *w);
void rlpw_list_end(rlpw_t *w, uint32_t mark);
uint32_t rlpw_overflowed(const rlpw_t *w);

#endif
