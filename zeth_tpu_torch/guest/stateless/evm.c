/* Guest EVM interpreter (Shanghai/Cancun): the program being proven.
 *
 * C port of the host engine app/csrc/evm.cpp (itself the re-creation of
 * revm for this framework; reference role SURVEY.md §2.2 reth-stateless
 * + revm 27.1). Differences forced by the RV32IM target:
 *   - gas is uint32 (block gas limits are < 2^31; cost formulas guard
 *     overflow by capping memory at 2^20 words ≈ 32MB, beyond any
 *     plausible gas budget);
 *   - keccak/sha256 route through accelerator syscalls; MULMOD/ADDMOD
 *     and ecrecover through SYS_BIGINT;
 *   - the bn254 pairing precompile (0x08) runs in-guest over the
 *     SYS_BIGINT accelerator (lib/bn254.c); the KZG point-eval (0x0a,
 *     BLS12-381) still faults the guest loudly (same "reject the block"
 *     contract as the host engine's evm.error path — blocks using it
 *     need the host validator).
 */
#include <stdint.h>
#include <string.h>
#include <alloc.h>
#include <zeth.h>
#include <keccak.h>
#include <hashes.h>
#include <u256.h>
#include <secp256k1.h>
#include <trie.h>
#include <rlp.h>
#include <gstate.h>
#include <gevm.h>
#include <bn254.h>
#include <bls381.h>
#include <kzg_setup.h>

gevm_env ENV;

#define MAX_DEPTH 1024
#define G_COLD_ACCOUNT 2600u
#define G_WARM 100u
#define G_COLD_SLOAD 2100u
#define MAX_MEM_WORDS (1u << 20)
#define OOG 0xFFFFFFFFu

typedef struct {
  uint8_t address[20];
  uint8_t caller[20];
  u256 value;
  const uint8_t *input;
  uint32_t input_len;
  const uint8_t *code;
  uint32_t code_len;
  uint32_t is_static;
} gframe;

/* per-call machine (heap-allocated; bump allocator, no free) */
typedef struct {
  u256 *stack;
  uint32_t sp;
  uint8_t *mem;
  uint32_t mem_words;
  uint32_t mem_cap;       /* bytes allocated */
  uint8_t *retdata;
  uint32_t retdata_len;
} machine;

static void call_frame(const gframe *f, uint32_t gas, uint32_t depth,
                       callres *res);

typedef struct {
  const uint8_t *caller;        /* 20 bytes */
  const u256 *value;
  const uint8_t *initcode;
  uint32_t initcode_len;
  uint32_t is_create2;
  const u256 *salt;
} createargs;

static void create_frame(const createargs *ca, uint32_t gas, uint32_t depth,
                         uint8_t out_addr[20], callres *res);
static uint32_t precompile(const uint8_t a[20], const uint8_t *input,
                           uint32_t input_len, uint32_t *gas,
                           uint8_t **out, uint32_t *out_len,
                           uint32_t *handled);

static uint32_t mem_gas(uint32_t words) {
  return 3u * words + (words * words) / 512u;
}

/* charge memory expansion; returns 0 on OOG (gas untouched on success
 * beyond the cost) */
static uint32_t mem_expand(machine *m, uint32_t *gas, u256 *off_u,
                           u256 *len_u, uint32_t *off_out, uint32_t *len_out) {
  uint32_t off, len, need, cost;
  if (!u256_fits_u32(len_u)) return 0;
  len = u256_low_u32(len_u);
  if (len == 0) {
    /* offset may be arbitrary when len == 0 */
    *off_out = 0;
    *len_out = 0;
    return 1;
  }
  if (!u256_fits_u32(off_u)) return 0;
  off = u256_low_u32(off_u);
  if (off > (1u << 30) || len > (1u << 30)) return 0;
  need = (off + len + 31u) / 32u;
  if (need > MAX_MEM_WORDS) return 0;
  if (need > m->mem_words) {
    cost = mem_gas(need) - mem_gas(m->mem_words);
    if (cost > *gas) return 0;
    *gas -= cost;
    if (need * 32u > m->mem_cap) {
      uint32_t ncap = m->mem_cap ? m->mem_cap : 4096;
      uint8_t *nb;
      while (ncap < need * 32u) ncap *= 2;
      nb = (uint8_t *)gmalloc(ncap);
      if (m->mem_cap) memcpy(nb, m->mem, m->mem_words * 32u);
      memset(nb + m->mem_words * 32u, 0, ncap - m->mem_words * 32u);
      m->mem = nb;
      m->mem_cap = ncap;
    } else {
      memset(m->mem + m->mem_words * 32u, 0,
             (need - m->mem_words) * 32u);
    }
    m->mem_words = need;
  }
  *off_out = off;
  *len_out = len;
  return 1;
}

static void addr_of(const u256 *v, uint8_t out[20]) {
  uint8_t be[32];
  u256_to_be(v, be);
  memcpy(out, be + 12, 20);
}

static uint32_t is_precompile_addr(const uint8_t a[20]) {
  uint32_t i;
  uint32_t hi = ENV.is_prague ? 0x11 : 0x0a;
  for (i = 0; i < 19; i++)
    if (a[i]) return 0;
  return a[19] >= 1 && a[19] <= hi;
}

/* EIP-7702 delegation designator: 0xef0100 || address */
static uint32_t is_delegation(const uint8_t *code, uint32_t len) {
  return len == 23 && code[0] == 0xef && code[1] == 0x01 && code[2] == 0x00;
}

/* 63/64 rule */
static uint32_t all_but_one_64th(uint32_t gas) { return gas - gas / 64u; }

static void ret_copy(machine *m, callres *cr) {
  m->retdata = cr->out;
  m->retdata_len = cr->out_len;
}

void call_frame(const gframe *f, uint32_t gas, uint32_t depth,
                callres *res) {
  machine M;
  uint8_t *jd;
  uint32_t pc = 0;
  const uint8_t *code = f->code;
  uint32_t code_len = f->code_len;
  gacct *self = gs_account(f->address);

  res->success = 0;
  res->gas_left = 0;
  res->out = 0;
  res->out_len = 0;
  if (code_len == 0) {
    res->success = 1;
    res->gas_left = gas;
    return;
  }
  memset(&M, 0, sizeof(M));
  M.stack = (u256 *)gmalloc(1025 * sizeof(u256));

  /* jumpdest bitmap */
  jd = (uint8_t *)gcalloc(code_len);
  {
    uint32_t i = 0;
    while (i < code_len) {
      uint8_t op = code[i];
      if (op == 0x5b) jd[i] = 1;
      if (op >= 0x60 && op <= 0x7f) i += op - 0x5e;
      else i += 1;
    }
  }

#define GAS(n) do { uint32_t _g = (n); if (_g > gas) goto oog; gas -= _g; } while (0)
#define NEED(n) do { if (M.sp < (n)) goto oog; } while (0)
#define TOP (&M.stack[M.sp - 1])
#define PUSHZ do { if (M.sp >= 1024) goto oog; \
    u256_zero(&M.stack[M.sp]); M.sp++; } while (0)

  while (pc < code_len) {
    uint32_t op = code[pc];
    switch (op) {
      case 0x00:                                               /* STOP */
        res->success = 1;
        res->gas_left = gas;
        return;
      case 0x01: {                                             /* ADD */
        GAS(3); NEED(2);
        u256_add(&M.stack[M.sp - 2], &M.stack[M.sp - 2], &M.stack[M.sp - 1]);
        M.sp--;
        break;
      }
      case 0x02: {                                             /* MUL */
        GAS(5); NEED(2);
        u256_mul(&M.stack[M.sp - 2], &M.stack[M.sp - 2], &M.stack[M.sp - 1]);
        M.sp--;
        break;
      }
      case 0x03: {                                             /* SUB */
        GAS(3); NEED(2);
        u256_sub(&M.stack[M.sp - 2], &M.stack[M.sp - 1], &M.stack[M.sp - 2]);
        M.sp--;
        break;
      }
      case 0x04: {                                             /* DIV */
        GAS(5); NEED(2);
        u256_div(&M.stack[M.sp - 2], &M.stack[M.sp - 1], &M.stack[M.sp - 2]);
        M.sp--;
        break;
      }
      case 0x05: {                                             /* SDIV */
        GAS(5); NEED(2);
        u256_sdiv(&M.stack[M.sp - 2], &M.stack[M.sp - 1], &M.stack[M.sp - 2]);
        M.sp--;
        break;
      }
      case 0x06: {                                             /* MOD */
        GAS(5); NEED(2);
        u256_mod(&M.stack[M.sp - 2], &M.stack[M.sp - 1], &M.stack[M.sp - 2]);
        M.sp--;
        break;
      }
      case 0x07: {                                             /* SMOD */
        GAS(5); NEED(2);
        u256_smod(&M.stack[M.sp - 2], &M.stack[M.sp - 1], &M.stack[M.sp - 2]);
        M.sp--;
        break;
      }
      case 0x08: {                                             /* ADDMOD */
        GAS(8); NEED(3);
        u256_addmod(&M.stack[M.sp - 3], &M.stack[M.sp - 1],
                    &M.stack[M.sp - 2], &M.stack[M.sp - 3]);
        M.sp -= 2;
        break;
      }
      case 0x09: {                                             /* MULMOD */
        GAS(8); NEED(3);
        u256_mulmod(&M.stack[M.sp - 3], &M.stack[M.sp - 1],
                    &M.stack[M.sp - 2], &M.stack[M.sp - 3]);
        M.sp -= 2;
        break;
      }
      case 0x0a: {                                             /* EXP */
        uint32_t ebytes;
        NEED(2);
        ebytes = (u256_bitlen(&M.stack[M.sp - 2]) + 7u) / 8u;
        GAS(10u + 50u * ebytes);
        u256_exp(&M.stack[M.sp - 2], &M.stack[M.sp - 1], &M.stack[M.sp - 2]);
        M.sp--;
        break;
      }
      case 0x0b: {                                             /* SIGNEXTEND */
        u256 *k, *v;
        GAS(5); NEED(2);
        k = &M.stack[M.sp - 1];
        v = &M.stack[M.sp - 2];
        if (u256_fits_u32(k) && u256_low_u32(k) < 31) {
          uint32_t bitpos = 8u * (u256_low_u32(k) + 1u) - 1u;
          u256 mask, one;
          u256_from_u32(&one, 1);
          u256_shl(&mask, &one, bitpos + 1);
          u256_sub(&mask, &mask, &one);          /* low mask */
          if (u256_bit(v, bitpos)) {
            u256 inv;
            u256_not(&inv, &mask);
            {
              uint32_t i;
              for (i = 0; i < 8; i++) v->w[i] |= inv.w[i];
            }
          } else {
            uint32_t i;
            for (i = 0; i < 8; i++) v->w[i] &= mask.w[i];
          }
        }
        M.sp--;
        break;
      }
      case 0x10: {                                             /* LT */
        GAS(3); NEED(2);
        {
          uint32_t r = u256_cmp(&M.stack[M.sp - 1], &M.stack[M.sp - 2]) < 0;
          u256_from_u32(&M.stack[M.sp - 2], r);
        }
        M.sp--;
        break;
      }
      case 0x11: {                                             /* GT */
        GAS(3); NEED(2);
        {
          uint32_t r = u256_cmp(&M.stack[M.sp - 1], &M.stack[M.sp - 2]) > 0;
          u256_from_u32(&M.stack[M.sp - 2], r);
        }
        M.sp--;
        break;
      }
      case 0x12: {                                             /* SLT */
        GAS(3); NEED(2);
        {
          uint32_t r = u256_scmp(&M.stack[M.sp - 1], &M.stack[M.sp - 2]) < 0;
          u256_from_u32(&M.stack[M.sp - 2], r);
        }
        M.sp--;
        break;
      }
      case 0x13: {                                             /* SGT */
        GAS(3); NEED(2);
        {
          uint32_t r = u256_scmp(&M.stack[M.sp - 1], &M.stack[M.sp - 2]) > 0;
          u256_from_u32(&M.stack[M.sp - 2], r);
        }
        M.sp--;
        break;
      }
      case 0x14: {                                             /* EQ */
        GAS(3); NEED(2);
        {
          uint32_t r = u256_eq(&M.stack[M.sp - 1], &M.stack[M.sp - 2]);
          u256_from_u32(&M.stack[M.sp - 2], r);
        }
        M.sp--;
        break;
      }
      case 0x15: {                                             /* ISZERO */
        GAS(3); NEED(1);
        u256_from_u32(TOP, u256_is_zero(TOP));
        break;
      }
      case 0x16: {                                             /* AND */
        uint32_t i;
        GAS(3); NEED(2);
        for (i = 0; i < 8; i++)
          M.stack[M.sp - 2].w[i] &= M.stack[M.sp - 1].w[i];
        M.sp--;
        break;
      }
      case 0x17: {                                             /* OR */
        uint32_t i;
        GAS(3); NEED(2);
        for (i = 0; i < 8; i++)
          M.stack[M.sp - 2].w[i] |= M.stack[M.sp - 1].w[i];
        M.sp--;
        break;
      }
      case 0x18: {                                             /* XOR */
        uint32_t i;
        GAS(3); NEED(2);
        for (i = 0; i < 8; i++)
          M.stack[M.sp - 2].w[i] ^= M.stack[M.sp - 1].w[i];
        M.sp--;
        break;
      }
      case 0x19: {                                             /* NOT */
        GAS(3); NEED(1);
        u256_not(TOP, TOP);
        break;
      }
      case 0x1a: {                                             /* BYTE */
        u256 *iv, *v;
        GAS(3); NEED(2);
        iv = &M.stack[M.sp - 1];
        v = &M.stack[M.sp - 2];
        if (u256_fits_u32(iv) && u256_low_u32(iv) < 32) {
          uint8_t be[32];
          u256_to_be(v, be);
          u256_from_u32(v, be[u256_low_u32(iv)]);
        } else {
          u256_zero(v);
        }
        M.sp--;
        break;
      }
      case 0x1b: {                                             /* SHL */
        u256 *s, *v;
        GAS(3); NEED(2);
        s = &M.stack[M.sp - 1];
        v = &M.stack[M.sp - 2];
        if (u256_fits_u32(s) && u256_low_u32(s) < 256)
          u256_shl(v, v, u256_low_u32(s));
        else
          u256_zero(v);
        M.sp--;
        break;
      }
      case 0x1c: {                                             /* SHR */
        u256 *s, *v;
        GAS(3); NEED(2);
        s = &M.stack[M.sp - 1];
        v = &M.stack[M.sp - 2];
        if (u256_fits_u32(s) && u256_low_u32(s) < 256)
          u256_shr(v, v, u256_low_u32(s));
        else
          u256_zero(v);
        M.sp--;
        break;
      }
      case 0x1d: {                                             /* SAR */
        u256 *s, *v;
        uint32_t sh;
        GAS(3); NEED(2);
        s = &M.stack[M.sp - 1];
        v = &M.stack[M.sp - 2];
        sh = (u256_fits_u32(s) && u256_low_u32(s) < 256)
                 ? u256_low_u32(s) : 256;
        u256_sar(v, v, sh);
        M.sp--;
        break;
      }
      case 0x20: {                                             /* KECCAK256 */
        uint32_t o, l;
        uint8_t d[32];
        NEED(2);
        GAS(30);
        if (!mem_expand(&M, &gas, &M.stack[M.sp - 1], &M.stack[M.sp - 2],
                        &o, &l))
          goto oog;
        GAS(6u * ((l + 31u) / 32u));
        keccak256(M.mem + o, l, d);
        u256_from_be(&M.stack[M.sp - 2], d);
        M.sp--;
        break;
      }
      case 0x30: {                                             /* ADDRESS */
        GAS(2); PUSHZ;
        u256_from_be_n(TOP, f->address, 20);
        break;
      }
      case 0x31: {                                             /* BALANCE */
        uint8_t a[20];
        gacct *acc;
        NEED(1);
        addr_of(TOP, a);
        acc = gs_account(a);
        GAS(gs_warm_account(acc) ? G_WARM : G_COLD_ACCOUNT);
        *TOP = acc->balance;
        break;
      }
      case 0x32: {                                             /* ORIGIN */
        GAS(2); PUSHZ;
        u256_from_be_n(TOP, ENV.origin, 20);
        break;
      }
      case 0x33: {                                             /* CALLER */
        GAS(2); PUSHZ;
        u256_from_be_n(TOP, f->caller, 20);
        break;
      }
      case 0x34: {                                             /* CALLVALUE */
        GAS(2); PUSHZ;
        *TOP = f->value;
        break;
      }
      case 0x35: {                                             /* CALLDATALOAD */
        uint8_t buf[32];
        u256 *off;
        GAS(3); NEED(1);
        off = TOP;
        memset(buf, 0, 32);
        if (u256_fits_u32(off)) {
          uint32_t o = u256_low_u32(off), i;
          for (i = 0; i < 32; i++)
            if (o + i < f->input_len && o + i >= o)
              buf[i] = f->input[o + i];
        }
        u256_from_be(TOP, buf);
        break;
      }
      case 0x36: {                                             /* CALLDATASIZE */
        GAS(2); PUSHZ;
        u256_from_u32(TOP, f->input_len);
        break;
      }
      case 0x37: {                                             /* CALLDATACOPY */
        uint32_t d, l, i;
        u256 *soff;
        NEED(3);
        GAS(3);
        if (!mem_expand(&M, &gas, &M.stack[M.sp - 1], &M.stack[M.sp - 3],
                        &d, &l))
          goto oog;
        GAS(3u * ((l + 31u) / 32u));
        soff = &M.stack[M.sp - 2];
        for (i = 0; i < l; i++) {
          uint32_t s = u256_fits_u32(soff)
                           ? u256_low_u32(soff) + i : 0xFFFFFFFFu;
          M.mem[d + i] = (s < f->input_len && s >= i) ? f->input[s] : 0;
        }
        M.sp -= 3;
        break;
      }
      case 0x38: {                                             /* CODESIZE */
        GAS(2); PUSHZ;
        u256_from_u32(TOP, code_len);
        break;
      }
      case 0x39: {                                             /* CODECOPY */
        uint32_t d, l, i;
        u256 *soff;
        NEED(3);
        GAS(3);
        if (!mem_expand(&M, &gas, &M.stack[M.sp - 1], &M.stack[M.sp - 3],
                        &d, &l))
          goto oog;
        GAS(3u * ((l + 31u) / 32u));
        soff = &M.stack[M.sp - 2];
        for (i = 0; i < l; i++) {
          uint32_t s = u256_fits_u32(soff)
                           ? u256_low_u32(soff) + i : 0xFFFFFFFFu;
          M.mem[d + i] = (s < code_len && s >= i) ? code[s] : 0;
        }
        M.sp -= 3;
        break;
      }
      case 0x3a: {                                             /* GASPRICE */
        GAS(2); PUSHZ;
        *TOP = ENV.gas_price;
        break;
      }
      case 0x3b: {                                             /* EXTCODESIZE */
        uint8_t a[20];
        gacct *acc;
        uint32_t cl;
        NEED(1);
        addr_of(TOP, a);
        acc = gs_account(a);
        GAS(gs_warm_account(acc) ? G_WARM : G_COLD_ACCOUNT);
        gs_code(acc, &cl);
        u256_from_u32(TOP, cl);
        break;
      }
      case 0x3c: {                                             /* EXTCODECOPY */
        uint8_t a[20];
        gacct *acc;
        uint32_t d, l, i, cl;
        uint8_t *c;
        u256 *soff;
        NEED(4);
        addr_of(&M.stack[M.sp - 1], a);
        acc = gs_account(a);
        GAS(gs_warm_account(acc) ? G_WARM : G_COLD_ACCOUNT);
        if (!mem_expand(&M, &gas, &M.stack[M.sp - 2], &M.stack[M.sp - 4],
                        &d, &l))
          goto oog;
        GAS(3u * ((l + 31u) / 32u));
        c = gs_code(acc, &cl);
        soff = &M.stack[M.sp - 3];
        for (i = 0; i < l; i++) {
          uint32_t s = u256_fits_u32(soff)
                           ? u256_low_u32(soff) + i : 0xFFFFFFFFu;
          M.mem[d + i] = (s < cl && s >= i) ? c[s] : 0;
        }
        M.sp -= 4;
        break;
      }
      case 0x3d: {                                             /* RETURNDATASIZE */
        GAS(2); PUSHZ;
        u256_from_u32(TOP, M.retdata_len);
        break;
      }
      case 0x3e: {                                             /* RETURNDATACOPY */
        uint32_t d, l, s;
        u256 *soff;
        NEED(3);
        GAS(3);
        soff = &M.stack[M.sp - 2];
        if (!u256_fits_u32(soff)) goto oog;
        s = u256_low_u32(soff);
        if (!mem_expand(&M, &gas, &M.stack[M.sp - 1], &M.stack[M.sp - 3],
                        &d, &l))
          goto oog;
        if (s > M.retdata_len || l > M.retdata_len - s) goto oog;
        GAS(3u * ((l + 31u) / 32u));
        if (l) memcpy(M.mem + d, M.retdata + s, l);
        M.sp -= 3;
        break;
      }
      case 0x3f: {                                             /* EXTCODEHASH */
        uint8_t a[20];
        gacct *acc;
        NEED(1);
        addr_of(TOP, a);
        acc = gs_account(a);
        GAS(gs_warm_account(acc) ? G_WARM : G_COLD_ACCOUNT);
        if (!acc->exists) u256_zero(TOP);
        else u256_from_be(TOP, acc->code_hash);
        break;
      }
      case 0x40: {                                             /* BLOCKHASH */
        u256 *nv;
        GAS(20); NEED(1);
        nv = TOP;
        {
          uint32_t found = 0;
          if (u256_fits_u32(nv)) {
            uint32_t n = u256_low_u32(nv);
            if (n < ENV.number && ENV.number - n <= 256
                && n <= ENV.ancestor_first
                && ENV.ancestor_first - n < ENV.n_ancestors) {
              u256_from_be(nv, ENV.ancestor_hashes
                                   + 32 * (ENV.ancestor_first - n));
              found = 1;
            }
          }
          if (!found) u256_zero(nv);
        }
        break;
      }
      case 0x41: {                                             /* COINBASE */
        GAS(2); PUSHZ;
        u256_from_be_n(TOP, ENV.coinbase, 20);
        break;
      }
      case 0x42: { GAS(2); PUSHZ; u256_from_u32(TOP, ENV.timestamp); break; }
      case 0x43: { GAS(2); PUSHZ; u256_from_u32(TOP, ENV.number); break; }
      case 0x44: { GAS(2); PUSHZ; *TOP = ENV.prevrandao; break; }
      case 0x45: { GAS(2); PUSHZ; u256_from_u32(TOP, ENV.gas_limit); break; }
      case 0x46: { GAS(2); PUSHZ; u256_from_u32(TOP, ENV.chain_id); break; }
      case 0x47: {                                             /* SELFBALANCE */
        GAS(5); PUSHZ;
        *TOP = self->balance;
        break;
      }
      case 0x48: { GAS(2); PUSHZ; *TOP = ENV.basefee; break; }
      case 0x49: {                                             /* BLOBHASH */
        u256 *iv;
        GAS(3); NEED(1);
        iv = TOP;
        if (u256_fits_u32(iv) && u256_low_u32(iv) < ENV.n_blob_hashes)
          *TOP = ENV.blob_hashes[u256_low_u32(iv)];
        else
          u256_zero(TOP);
        break;
      }
      case 0x4a: { GAS(2); PUSHZ; *TOP = ENV.blob_basefee; break; }
      case 0x50: { GAS(2); NEED(1); M.sp--; break; }           /* POP */
      case 0x51: {                                             /* MLOAD */
        uint32_t o, l;
        u256 len32;
        NEED(1);
        GAS(3);
        u256_from_u32(&len32, 32);
        if (!mem_expand(&M, &gas, TOP, &len32, &o, &l)) goto oog;
        u256_from_be(TOP, M.mem + o);
        break;
      }
      case 0x52: {                                             /* MSTORE */
        uint32_t o, l;
        u256 len32;
        NEED(2);
        GAS(3);
        u256_from_u32(&len32, 32);
        if (!mem_expand(&M, &gas, &M.stack[M.sp - 1], &len32, &o, &l))
          goto oog;
        u256_to_be(&M.stack[M.sp - 2], M.mem + o);
        M.sp -= 2;
        break;
      }
      case 0x53: {                                             /* MSTORE8 */
        uint32_t o, l;
        u256 len1;
        NEED(2);
        GAS(3);
        u256_from_u32(&len1, 1);
        if (!mem_expand(&M, &gas, &M.stack[M.sp - 1], &len1, &o, &l))
          goto oog;
        M.mem[o] = (uint8_t)M.stack[M.sp - 2].w[0];
        M.sp -= 2;
        break;
      }
      case 0x54: {                                             /* SLOAD */
        uint8_t k[32];
        NEED(1);
        u256_to_be(TOP, k);
        GAS(gs_warm_slot(self, k) ? G_WARM : G_COLD_SLOAD);
        gs_sload(self, k, TOP);
        break;
      }
      case 0x55: {                                             /* SSTORE */
        uint8_t k[32];
        u256 cur, orig, *nv;
        uint32_t warm, cost;
        if (f->is_static) goto oog;
        NEED(2);
        if (gas <= 2300) goto oog;
        u256_to_be(&M.stack[M.sp - 1], k);
        nv = &M.stack[M.sp - 2];
        warm = gs_warm_slot(self, k);
        gs_sload(self, k, &cur);
        gs_original(self, k, &orig);
        cost = warm ? 0 : G_COLD_SLOAD;
        if (u256_eq(&cur, nv)) cost += 100;
        else if (u256_eq(&orig, &cur))
          cost += u256_is_zero(&orig) ? 20000 : 2900;
        else cost += 100;
        GAS(cost);
        if (!u256_eq(&cur, nv)) {
          if (u256_eq(&orig, &cur)) {
            if (!u256_is_zero(&orig) && u256_is_zero(nv))
              gs_add_refund(4800, 0);
          } else {
            if (!u256_is_zero(&orig)) {
              if (u256_is_zero(&cur)) gs_add_refund(4800, 1);
              else if (u256_is_zero(nv)) gs_add_refund(4800, 0);
            }
            if (u256_eq(&orig, nv))
              gs_add_refund(u256_is_zero(&orig) ? 19900 : 2800, 0);
          }
        }
        gs_sstore(self, k, nv);
        M.sp -= 2;
        break;
      }
      case 0x56: {                                             /* JUMP */
        u256 *d;
        GAS(8); NEED(1);
        d = TOP;
        if (!u256_fits_u32(d) || u256_low_u32(d) >= code_len
            || !jd[u256_low_u32(d)])
          goto oog;
        pc = u256_low_u32(d);
        M.sp--;
        continue;
      }
      case 0x57: {                                             /* JUMPI */
        u256 *d, *c;
        GAS(10); NEED(2);
        d = &M.stack[M.sp - 1];
        c = &M.stack[M.sp - 2];
        if (!u256_is_zero(c)) {
          if (!u256_fits_u32(d) || u256_low_u32(d) >= code_len
              || !jd[u256_low_u32(d)])
            goto oog;
          pc = u256_low_u32(d);
          M.sp -= 2;
          continue;
        }
        M.sp -= 2;
        break;
      }
      case 0x58: { GAS(2); PUSHZ; u256_from_u32(TOP, pc); break; }
      case 0x59: {                                             /* MSIZE */
        GAS(2); PUSHZ;
        u256_from_u32(TOP, M.mem_words * 32u);
        break;
      }
      case 0x5a: { GAS(2); PUSHZ; u256_from_u32(TOP, gas); break; }
      case 0x5b: { GAS(1); break; }                            /* JUMPDEST */
      case 0x5c: {                                             /* TLOAD */
        uint8_t k[32];
        GAS(100); NEED(1);
        u256_to_be(TOP, k);
        gs_tload(self, k, TOP);
        break;
      }
      case 0x5d: {                                             /* TSTORE */
        uint8_t k[32];
        if (f->is_static) goto oog;
        GAS(100); NEED(2);
        u256_to_be(&M.stack[M.sp - 1], k);
        gs_tstore(self, k, &M.stack[M.sp - 2]);
        M.sp -= 2;
        break;
      }
      case 0x5e: {                                             /* MCOPY */
        uint32_t d, s, l, l2;
        NEED(3);
        GAS(3);
        if (!mem_expand(&M, &gas, &M.stack[M.sp - 1], &M.stack[M.sp - 3],
                        &d, &l))
          goto oog;
        if (!mem_expand(&M, &gas, &M.stack[M.sp - 2], &M.stack[M.sp - 3],
                        &s, &l2))
          goto oog;
        GAS(3u * ((l + 31u) / 32u));
        if (l) memmove(M.mem + d, M.mem + s, l);
        M.sp -= 3;
        break;
      }
      case 0x5f: { GAS(2); PUSHZ; break; }                     /* PUSH0 */
      case 0xf3:                                               /* RETURN */
      case 0xfd: {                                             /* REVERT */
        uint32_t o, l;
        NEED(2);
        if (!mem_expand(&M, &gas, &M.stack[M.sp - 1], &M.stack[M.sp - 2],
                        &o, &l))
          goto oog;
        res->out = (uint8_t *)gmalloc(l ? l : 1);
        memcpy(res->out, M.mem + o, l);
        res->out_len = l;
        res->success = op == 0xf3;
        res->gas_left = gas;
        return;
      }
      case 0xfe:
        goto oog;                                              /* INVALID */
      case 0xff: {                                             /* SELFDESTRUCT */
        uint8_t ben[20];
        gacct *bacc;
        u256 bal;
        if (f->is_static) goto oog;
        NEED(1);
        addr_of(TOP, ben);
        M.sp--;
        GAS(5000);
        bacc = gs_account(ben);
        if (!gs_warm_account(bacc)) GAS(G_COLD_ACCOUNT);
        bal = self->balance;
        if (!u256_is_zero(&bal) && !bacc->exists) GAS(25000);
        {
          u256 z;
          u256_zero(&z);
          gs_set_balance(self, &z);
        }
        if (memcmp(ben, f->address, 20) != 0) {
          if (!bacc->exists && !u256_is_zero(&bal)) gs_mark_created(bacc);
          {
            u256 nb;
            u256_add(&nb, &bacc->balance, &bal);
            gs_set_balance(bacc, &nb);
          }
        }
        if (gs_was_created_this_tx(self)) gs_mark_destroyed(self);
        res->success = 1;
        res->gas_left = gas;
        return;
      }
      default:
        if (op >= 0x60 && op <= 0x7f) {                        /* PUSHn */
          uint32_t n = op - 0x5f, i;
          uint8_t buf[32];
          GAS(3);
          if (M.sp >= 1024) goto oog;
          memset(buf, 0, 32);
          for (i = 0; i < n; i++)
            if (pc + 1 + i < code_len) buf[32 - n + i] = code[pc + 1 + i];
          u256_from_be(&M.stack[M.sp], buf);
          M.sp++;
          pc += n + 1;
          continue;
        }
        if (op >= 0x80 && op <= 0x8f) {                        /* DUPn */
          uint32_t n = op - 0x7f;
          GAS(3); NEED(n);
          if (M.sp >= 1024) goto oog;
          M.stack[M.sp] = M.stack[M.sp - n];
          M.sp++;
          break;
        }
        if (op >= 0x90 && op <= 0x9f) {                        /* SWAPn */
          uint32_t n = op - 0x8f;
          u256 t;
          GAS(3); NEED(n + 1);
          t = M.stack[M.sp - 1];
          M.stack[M.sp - 1] = M.stack[M.sp - 1 - n];
          M.stack[M.sp - 1 - n] = t;
          break;
        }
        if (op >= 0xa0 && op <= 0xa4) {                        /* LOGn */
          uint32_t n = op - 0xa0, o, l, i;
          uint8_t topics[4][32];
          if (f->is_static) goto oog;
          NEED(2 + n);
          if (!mem_expand(&M, &gas, &M.stack[M.sp - 1], &M.stack[M.sp - 2],
                          &o, &l))
            goto oog;
          GAS(375u + 375u * n + 8u * l);
          M.sp -= 2;
          for (i = 0; i < n; i++) {
            u256_to_be(&M.stack[M.sp - 1], topics[i]);
            M.sp--;
          }
          gs_add_log(f->address, n, topics, M.mem + o, l);
          break;
        }
        if (op == 0xf0 || op == 0xf5) {                        /* CREATE/2 */
          uint32_t is2 = op == 0xf5, o, l, words, cgas;
          u256 value, salt;
          callres cr;
          uint8_t created[20];
          if (f->is_static) goto oog;
          NEED(is2 ? 4u : 3u);
          value = M.stack[M.sp - 1];
          GAS(32000);
          if (!mem_expand(&M, &gas, &M.stack[M.sp - 2], &M.stack[M.sp - 3],
                          &o, &l))
            goto oog;
          if (is2) salt = M.stack[M.sp - 4];
          else u256_zero(&salt);
          M.sp -= is2 ? 4 : 3;
          words = (l + 31u) / 32u;
          GAS(2u * words + (is2 ? 6u * words : 0u));
          if (l > 49152) goto oog;
          cgas = all_but_one_64th(gas);
          gas -= cgas;
          {
            createargs ca;
            ca.caller = f->address;
            ca.value = &value;
            ca.initcode = M.mem + o;
            ca.initcode_len = l;
            ca.is_create2 = is2;
            ca.salt = &salt;
            create_frame(&ca, cgas, depth + 1, created, &cr);
          }
          gas += cr.gas_left;
          if (cr.success) {
            M.retdata = 0;
            M.retdata_len = 0;
            PUSHZ;
            u256_from_be_n(TOP, created, 20);
          } else {
            ret_copy(&M, &cr);
            PUSHZ;
          }
          break;
        }
        if (op == 0xf1 || op == 0xf2 || op == 0xf4 || op == 0xfa) {
          /* CALL/CALLCODE/DELEGATECALL/STATICCALL */
          uint32_t has_value = op == 0xf1 || op == 0xf2;
          u256 gv, value;
          uint8_t target[20];
          uint32_t io, il, oo, ol, dummy, cgas, avail, extra;
          gacct *tacc;
          uint8_t *tcode;
          uint32_t tcl;
          callres cr;
          NEED(has_value ? 7u : 6u);
          gv = M.stack[M.sp - 1];
          addr_of(&M.stack[M.sp - 2], target);
          if (has_value) value = M.stack[M.sp - 3];
          else u256_zero(&value);
          {
            uint32_t base = has_value ? 4u : 3u;
            if (f->is_static && op == 0xf1 && !u256_is_zero(&value))
              goto oog;
            if (!mem_expand(&M, &gas, &M.stack[M.sp - base],
                            &M.stack[M.sp - base - 1], &io, &il))
              goto oog;
            if (!mem_expand(&M, &gas, &M.stack[M.sp - base - 2],
                            &M.stack[M.sp - base - 3], &oo, &ol))
              goto oog;
            M.sp -= base + 3;
          }
          (void)dummy;
          tacc = gs_account(target);
          GAS(gs_warm_account(tacc) ? G_WARM : G_COLD_ACCOUNT);
          /* EIP-7702: execution follows a delegation designator (one
           * hop), charging the delegate's account-access cost */
          tcode = gs_code(tacc, &tcl);
          if (ENV.is_prague && is_delegation(tcode, tcl)) {
            gacct *dacc = gs_account(tcode + 3);
            GAS(gs_warm_account(dacc) ? G_WARM : G_COLD_ACCOUNT);
            tcode = gs_code(dacc, &tcl);
          }
          extra = 0;
          if (!u256_is_zero(&value)) {
            extra += 9000;
            if (!tacc->exists && op == 0xf1) extra += 25000;
          }
          GAS(extra);
          avail = all_but_one_64th(gas);
          cgas = (u256_fits_u32(&gv) && u256_low_u32(&gv) < avail)
                     ? u256_low_u32(&gv) : avail;
          gas -= cgas;
          if (!u256_is_zero(&value)) cgas += 2300;
          memset(&cr, 0, sizeof(cr));
          if (depth + 1 > MAX_DEPTH) {
            cr.success = 0;
            cr.gas_left = cgas;
          } else {
            uint32_t snap = gs_snapshot();
            uint32_t ok = 1;
            if (!u256_is_zero(&value) && op == 0xf1) {
              if (u256_cmp(&self->balance, &value) < 0) ok = 0;
              else {
                u256 nb;
                u256_sub(&nb, &self->balance, &value);
                gs_set_balance(self, &nb);
                if (!tacc->exists) gs_mark_created(tacc);
                u256_add(&nb, &tacc->balance, &value);
                gs_set_balance(tacc, &nb);
              }
            }
            if (!ok) {
              cr.success = 0;
              cr.gas_left = cgas;
            } else {
              uint32_t handled = 0;
              uint32_t pgas = cgas;
              uint8_t *pout = 0;
              uint32_t pout_len = 0;
              uint32_t psucc = precompile(target, M.mem + io, il, &pgas,
                                          &pout, &pout_len, &handled);
              if (handled && psucc) {
                cr.success = 1;
                cr.gas_left = pgas;
                cr.out = pout;
                cr.out_len = pout_len;
              } else if (handled) {
                cr.success = 0;
                cr.gas_left = 0;
              } else {
                gframe sub;
                memset(&sub, 0, sizeof(sub));
                memcpy(sub.caller, f->address, 20);
                if (op == 0xf4) sub.value = f->value;
                else sub.value = value;
                /* input copied: callee must not see caller mem growth */
                {
                  uint8_t *inb = (uint8_t *)gmalloc(il ? il : 1);
                  memcpy(inb, M.mem + io, il);
                  sub.input = inb;
                }
                sub.input_len = il;
                sub.is_static = f->is_static || op == 0xfa;
                sub.code = tcode;
                sub.code_len = tcl;
                if (op == 0xf2 || op == 0xf4) {
                  memcpy(sub.address, f->address, 20);
                } else {
                  memcpy(sub.address, target, 20);
                }
                if (op == 0xf4) memcpy(sub.caller, f->caller, 20);
                call_frame(&sub, cgas, depth + 1, &cr);
              }
              if (!cr.success) gs_revert(snap);
            }
          }
          ret_copy(&M, &cr);
          {
            uint32_t copy = ol < cr.out_len ? ol : cr.out_len;
            if (copy) memcpy(M.mem + oo, cr.out, copy);
          }
          gas += cr.gas_left;
          PUSHZ;
          u256_from_u32(TOP, cr.success ? 1 : 0);
          break;
        }
        goto oog;                                              /* unknown */
    }
    pc += 1;
  }
  res->success = 1;
  res->gas_left = gas;
  return;

oog:
  res->success = 0;
  res->gas_left = 0;
  res->out = 0;
  res->out_len = 0;
}

/* -- CREATE ----------------------------------------------------------------- */

void create_frame(const createargs *ca, uint32_t gas, uint32_t depth,
                  uint8_t out_addr[20], callres *res) {
  const uint8_t *caller = ca->caller;
  const u256 *value = ca->value;
  const uint8_t *initcode = ca->initcode;
  uint32_t initcode_len = ca->initcode_len;
  uint32_t is_create2 = ca->is_create2;
  const u256 *salt = ca->salt;
  gacct *cacc = gs_account(caller);
  uint8_t created[20];
  gacct *tacc;
  uint32_t snap;

  res->success = 0;
  res->gas_left = gas;
  res->out = 0;
  res->out_len = 0;
  if (depth > MAX_DEPTH) return;
  if (u256_cmp(&cacc->balance, value) < 0) return;
  if (cacc->nonce == 0xFFFFFFFFu) return;

  if (is_create2) {
    uint8_t buf[85];
    uint8_t h[32];
    buf[0] = 0xff;
    memcpy(buf + 1, caller, 20);
    u256_to_be(salt, buf + 21);
    keccak256(initcode, initcode_len, h);
    memcpy(buf + 53, h, 32);
    keccak256(buf, 85, h);
    memcpy(created, h + 12, 20);
  } else {
    /* keccak(rlp([caller, nonce]))[12:] */
    uint8_t enc[40];
    uint8_t h[32];
    rlpw_t w;
    uint32_t mark;
    rlpw_init(&w, enc, 40);
    mark = rlpw_list_begin(&w);
    rlpw_bytes(&w, caller, 20);
    rlpw_u32(&w, cacc->nonce);
    rlpw_list_end(&w, mark);
    keccak256(w.buf, w.len, h);
    memcpy(created, h + 12, 20);
  }
  memcpy(out_addr, created, 20);

  gs_set_nonce(cacc, cacc->nonce + 1);
  tacc = gs_account(created);
  gs_warm_account(tacc);

  if (tacc->exists) {
    uint32_t cl;
    gs_code(tacc, &cl);
    if (tacc->nonce != 0
        || memcmp(tacc->code_hash, GS_EMPTY_CODE_HASH, 32) != 0) {
      res->gas_left = 0;
      return;
    }
  }

  snap = gs_snapshot();
  gs_mark_created(tacc);
  gs_set_nonce(tacc, 1);
  if (!u256_is_zero(value)) {
    u256 nb;
    u256_sub(&nb, &cacc->balance, value);
    gs_set_balance(cacc, &nb);
    u256_add(&nb, &tacc->balance, value);
    gs_set_balance(tacc, &nb);
  }

  {
    gframe frame;
    callres run;
    memset(&frame, 0, sizeof(frame));
    memcpy(frame.address, created, 20);
    memcpy(frame.caller, caller, 20);
    frame.value = *value;
    frame.code = initcode;
    frame.code_len = initcode_len;
    call_frame(&frame, gas, depth, &run);
    if (run.success) {
      uint32_t code_gas = 200u * run.out_len;
      if (run.out_len > 24576
          || (run.out_len != 0 && run.out[0] == 0xef)
          || code_gas > run.gas_left) {
        gs_revert(snap);
        res->gas_left = 0;
        return;
      }
      run.gas_left -= code_gas;
      gs_set_code(tacc, run.out ? run.out : (uint8_t *)gmalloc(1),
                  run.out_len);
      res->success = 1;
      res->gas_left = run.gas_left;
      return;
    }
    gs_revert(snap);
    res->success = 0;
    res->gas_left = run.gas_left;
    res->out = run.out;
    res->out_len = run.out_len;
  }
}

/* -- precompiles 0x01..0x0a -------------------------------------------------- */

/* KZG (0x0a) scratch: the precompile switch shares one stack frame and
 * zeth-cc caps it at 2 KB */
static uint8_t kzg_vh[32];

/* bn254 group ops via the bigint accelerator (precompiles 0x06/0x07) */
static const uint32_t BNP_W[8] = {
  0xD87CFD47, 0x3C208C16, 0x6871CA8D, 0x97816A91,
  0x8181585D, 0xB85045B6, 0xE131A029, 0x30644E72};

typedef struct { u256 x, y; uint32_t inf; } bnpt;

static u256 BNP;

static void bn_fmul(u256 *r, const u256 *a, const u256 *b) {
  u256_modmul_raw(r, a, b, &BNP);
}

static void bn_fadd(u256 *r, const u256 *a, const u256 *b) {
  uint32_t c = u256_add(r, a, b);
  if (c || u256_cmp(r, &BNP) >= 0) u256_sub(r, r, &BNP);
}

static void bn_fsub(u256 *r, const u256 *a, const u256 *b) {
  if (u256_cmp(a, b) >= 0) {
    u256_sub(r, a, b);
  } else {
    u256 t;
    u256_sub(&t, b, a);
    u256_sub(r, &BNP, &t);
  }
}

static void bn_finv(u256 *r, const u256 *a) {
  u256 e, two;
  uint32_t bl;
  u256 acc, base;
  u256_from_u32(&two, 2);
  u256_sub(&e, &BNP, &two);
  u256_from_u32(&acc, 1);
  base = *a;
  bl = u256_bitlen(&e);
  {
    uint32_t i;
    for (i = 0; i < bl; i++) {
      if (u256_bit(&e, i)) bn_fmul(&acc, &acc, &base);
      if (i + 1 < bl) bn_fmul(&base, &base, &base);
    }
  }
  *r = acc;
}

static uint32_t bn_on_curve(const bnpt *P) {
  u256 y2, x3, t;
  if (P->inf) return 1;
  if (u256_cmp(&P->x, &BNP) >= 0 || u256_cmp(&P->y, &BNP) >= 0) return 0;
  bn_fmul(&y2, &P->y, &P->y);
  bn_fmul(&x3, &P->x, &P->x);
  bn_fmul(&x3, &x3, &P->x);
  u256_from_u32(&t, 3);
  bn_fadd(&x3, &x3, &t);
  return u256_eq(&y2, &x3);
}

static void bn_add_pt(bnpt *r, const bnpt *P1, const bnpt *P2) {
  u256 lam, t, t2;
  bnpt o;
  if (P1->inf) { *r = *P2; return; }
  if (P2->inf) { *r = *P1; return; }
  if (u256_eq(&P1->x, &P2->x)) {
    u256 sum;
    bn_fadd(&sum, &P1->y, &P2->y);
    if (u256_is_zero(&sum)) {
      r->inf = 1;
      u256_zero(&r->x);
      u256_zero(&r->y);
      return;
    }
    /* lam = 3x^2 / 2y */
    bn_fmul(&t, &P1->x, &P1->x);
    bn_fadd(&t2, &t, &t);
    bn_fadd(&t, &t2, &t);
    bn_fadd(&t2, &P1->y, &P1->y);
    bn_finv(&t2, &t2);
    bn_fmul(&lam, &t, &t2);
  } else {
    bn_fsub(&t, &P2->y, &P1->y);
    bn_fsub(&t2, &P2->x, &P1->x);
    bn_finv(&t2, &t2);
    bn_fmul(&lam, &t, &t2);
  }
  bn_fmul(&t, &lam, &lam);
  bn_fsub(&t, &t, &P1->x);
  bn_fsub(&o.x, &t, &P2->x);
  bn_fsub(&t, &P1->x, &o.x);
  bn_fmul(&t, &lam, &t);
  bn_fsub(&o.y, &t, &P1->y);
  o.inf = 0;
  *r = o;
}

static void bn_mul_pt(bnpt *r, const bnpt *P, const u256 *k) {
  bnpt acc, base;
  uint32_t bl, i;
  acc.inf = 1;
  u256_zero(&acc.x);
  u256_zero(&acc.y);
  base = *P;
  bl = u256_bitlen(k);
  for (i = 0; i < bl; i++) {
    if (u256_bit(k, i)) bn_add_pt(&acc, &acc, &base);
    if (i + 1 < bl) bn_add_pt(&base, &base, &base);
  }
  *r = acc;
}

/* -- modexp (0x05, EIP-2565) over big-endian byte vectors ----------------- */

static int b_cmp(const uint8_t *x, uint32_t nx, const uint8_t *y,
                 uint32_t ny) {
  uint32_t n = nx > ny ? nx : ny, i;
  for (i = 0; i < n; i++) {
    uint8_t xb = i + nx >= n ? x[i - (n - nx)] : 0;
    uint8_t yb = i + ny >= n ? y[i - (n - ny)] : 0;
    if (xb != yb) return xb < yb ? -1 : 1;
  }
  return 0;
}

static void b_sub(uint8_t *x, uint32_t nx, const uint8_t *y, uint32_t ny) {
  uint32_t borrow = 0, i;
  for (i = 0; i < nx; i++) {
    uint32_t xi = x[nx - 1 - i];
    uint32_t yi = i < ny ? y[ny - 1 - i] : 0;
    uint32_t d = xi - yi - borrow;
    borrow = (d >> 31) & 1;          /* went negative */
    x[nx - 1 - i] = (uint8_t)d;
  }
}

/* x mod m in place (x has nx bytes; m is nonzero). Bit-shift subtract:
 * iterate m << k from high to low. Buffers sized <= 2 * 1025. */
static void b_mod(uint8_t *x, uint32_t nx, const uint8_t *m, uint32_t nm) {
  /* normalize m (strip leading zeros) */
  uint32_t ms = 0;
  int32_t shift;
  while (ms < nm && m[ms] == 0) ms++;
  if (ms == nm) return;
  {
    const uint8_t *mm = m + ms;
    uint32_t mlen = nm - ms;
    /* max shift so (m << s) has at most nx bytes + partial bits */
    uint8_t *sh = (uint8_t *)gmalloc(nx + 1);
    for (shift = (int32_t)(8 * (nx - mlen + 1)); shift >= 0; shift--) {
      /* sh = mm << shift, big-endian, into nx+1 bytes */
      uint32_t bytes = (uint32_t)shift >> 3, bits = (uint32_t)shift & 7;
      uint32_t slen = mlen + bytes + (bits ? 1 : 0);
      uint32_t i;
      if (slen > nx + 1) continue;
      memset(sh, 0, nx + 1);
      if (bits == 0) {
        memcpy(sh + (nx + 1) - bytes - mlen, mm, mlen);
      } else {
        uint32_t carry = 0;
        for (i = 0; i < mlen; i++) {
          uint32_t v = ((uint32_t)mm[mlen - 1 - i] << bits) | carry;
          sh[(nx + 1) - 1 - bytes - i] = (uint8_t)v;
          carry = v >> 8;
        }
        sh[(nx + 1) - 1 - bytes - mlen] = (uint8_t)carry;
      }
      while (b_cmp(x, nx, sh, nx + 1) >= 0)
        b_sub(x, nx, sh, nx + 1);
    }
  }
}

/* r = x * y (big-endian byte vectors), r has nx+ny bytes */
static void b_mul(const uint8_t *x, uint32_t nx, const uint8_t *y,
                  uint32_t ny, uint8_t *r) {
  uint32_t i, j;
  memset(r, 0, nx + ny);
  for (i = 0; i < nx; i++) {
    uint32_t carry = 0;
    uint32_t xi = x[nx - 1 - i];
    if (xi == 0) continue;
    for (j = 0; j < ny; j++) {
      uint32_t pos = nx + ny - 1 - i - j;
      uint32_t v = (uint32_t)r[pos] + xi * (uint32_t)y[ny - 1 - j] + carry;
      r[pos] = (uint8_t)v;
      carry = v >> 8;
    }
    {
      uint32_t pos = nx + ny - 1 - i - ny;
      while (carry) {
        uint32_t v = (uint32_t)r[pos] + carry;
        r[pos] = (uint8_t)v;
        carry = v >> 8;
        if (pos == 0) break;
        pos--;
      }
    }
  }
}

static uint32_t pre_modexp(const uint8_t *input, uint32_t input_len,
                           uint32_t *gas, uint8_t **out,
                           uint32_t *out_len) {
  uint8_t head[96];
  u256 blv, elv, mlv;
  uint32_t blen, elen, mlen, i;
  memset(head, 0, 96);
  memcpy(head, input, input_len < 96 ? input_len : 96);
  u256_from_be(&blv, head);
  u256_from_be(&elv, head + 32);
  u256_from_be(&mlv, head + 64);
  if (!u256_fits_u32(&blv) || !u256_fits_u32(&elv) || !u256_fits_u32(&mlv))
    return 0;
  blen = u256_low_u32(&blv);
  elen = u256_low_u32(&elv);
  mlen = u256_low_u32(&mlv);
  if (blen > 1024 || elen > 1024 || mlen > 1024) return 0;
  {
    uint32_t maxlen = blen > mlen ? blen : mlen;
    uint32_t words = (maxlen + 7u) / 8u;
    uint32_t mult = words * words;
    uint8_t *bb = (uint8_t *)gcalloc(blen ? blen : 1);
    uint8_t *ee = (uint8_t *)gcalloc(elen ? elen : 1);
    uint8_t *mm = (uint8_t *)gcalloc(mlen ? mlen : 1);
    uint32_t ebits = 0, iter, cost, first = 0;
    for (i = 0; i < blen; i++)
      if (96u + i < input_len) bb[i] = input[96u + i];
    for (i = 0; i < elen; i++)
      if (96u + blen + i < input_len) ee[i] = input[96u + blen + i];
    for (i = 0; i < mlen; i++)
      if (96u + blen + elen + i < input_len)
        mm[i] = input[96u + blen + elen + i];
    while (first < elen && ee[first] == 0) first++;
    if (first < elen) {
      uint32_t tail = elen - first - 1;
      uint32_t top = ee[first], tb = 0;
      while (top) { tb++; top >>= 1; }
      ebits = 8u * tail + (tb ? tb - 1u : 0u);
    }
    iter = ebits > 1u ? ebits : 1u;
    if (elen > 32) {
      iter = 8u * (elen - 32u) + ebits;
      if (iter < 1) iter = 1;
    }
    cost = mult * (iter / 3u) + (mult * (iter % 3u)) / 3u;
    if (cost < 200) cost = 200;
    if (*gas < cost) return 0;
    *gas -= cost;
    *out = (uint8_t *)gcalloc(mlen ? mlen : 1);
    *out_len = mlen;
    if (mlen == 0) return 1;
    {
      uint32_t mzero = 1;
      for (i = 0; i < mlen; i++)
        if (mm[i]) { mzero = 0; break; }
      if (mzero) return 1;
    }
    {
      /* square-and-multiply over byte vectors, all mod m (<= mlen+1B) */
      uint8_t *base = (uint8_t *)gcalloc(mlen + 1);
      uint8_t *r = (uint8_t *)gcalloc(mlen + 1);
      uint8_t *prod = (uint8_t *)gmalloc(2 * (mlen + 1));
      uint32_t bit;
      /* base = bb mod m */
      if (blen > mlen) {
        uint8_t *tmp = (uint8_t *)gmalloc(blen);
        memcpy(tmp, bb, blen);
        b_mod(tmp, blen, mm, mlen);
        memcpy(base + 1, tmp + blen - mlen, mlen);
      } else {
        memcpy(base + 1 + (mlen - blen), bb, blen);
        b_mod(base, mlen + 1, mm, mlen);
      }
      r[mlen] = 1;
      for (bit = 0; bit < 8 * elen; bit++) {
        uint32_t idx = bit >> 3;
        uint32_t bval = (ee[idx] >> (7 - (bit & 7))) & 1;
        if (bit) {
          b_mul(r, mlen + 1, r, mlen + 1, prod);
          b_mod(prod, 2 * (mlen + 1), mm, mlen);
          memcpy(r, prod + mlen + 1, mlen + 1);
        }
        if (bval) {
          b_mul(r, mlen + 1, base, mlen + 1, prod);
          b_mod(prod, 2 * (mlen + 1), mm, mlen);
          memcpy(r, prod + mlen + 1, mlen + 1);
        }
      }
      memcpy(*out, r + 1, mlen);
    }
    return 1;
  }
}

uint32_t precompile(const uint8_t a[20], const uint8_t *input,
                    uint32_t input_len, uint32_t *gas, uint8_t **out,
                    uint32_t *out_len, uint32_t *handled) {
  uint32_t id;
  *handled = 0;
  *out = 0;
  *out_len = 0;
  if (!is_precompile_addr(a)) return 0;
  id = a[19];
  *handled = 1;
  switch (id) {
    case 0x1: {                                                /* ecrecover */
      uint8_t buf[128];
      u256 v, r, s;
      uint8_t addr[20];
      if (*gas < 3000) return 0;
      *gas -= 3000;
      memset(buf, 0, 128);
      memcpy(buf, input, input_len < 128 ? input_len : 128);
      u256_from_be(&v, buf + 32);
      u256_from_be(&r, buf + 64);
      u256_from_be(&s, buf + 96);
      if (!u256_fits_u32(&v)
          || (u256_low_u32(&v) != 27 && u256_low_u32(&v) != 28))
        return 1;                                  /* empty output */
      if (secp_ecrecover(buf, u256_low_u32(&v) - 27, &r, &s, addr)) {
        *out = (uint8_t *)gcalloc(32);
        memcpy(*out + 12, addr, 20);
        *out_len = 32;
      }
      return 1;
    }
    case 0x2: {                                                /* sha256 */
      uint32_t words = (input_len + 31u) / 32u;
      uint32_t cost = 60u + 12u * words;
      if (*gas < cost) return 0;
      *gas -= cost;
      *out = (uint8_t *)gmalloc(32);
      sha256(input, input_len, *out);
      *out_len = 32;
      return 1;
    }
    case 0x3: {                                                /* ripemd160 */
      uint32_t words = (input_len + 31u) / 32u;
      uint32_t cost = 600u + 120u * words;
      if (*gas < cost) return 0;
      *gas -= cost;
      *out = (uint8_t *)gcalloc(32);
      ripemd160(input, input_len, *out + 12);
      *out_len = 32;
      return 1;
    }
    case 0x4: {                                                /* identity */
      uint32_t words = (input_len + 31u) / 32u;
      uint32_t cost = 15u + 3u * words;
      if (*gas < cost) return 0;
      *gas -= cost;
      *out = (uint8_t *)gmalloc(input_len ? input_len : 1);
      memcpy(*out, input, input_len);
      *out_len = input_len;
      return 1;
    }
    case 0x5:                                                  /* modexp */
      return pre_modexp(input, input_len, gas, out, out_len);
    case 0x6: {                                                /* bn add */
      uint8_t buf[128];
      bnpt P1, P2, R;
      if (*gas < 150) return 0;
      *gas -= 150;
      memcpy(BNP.w, BNP_W, 32);
      memset(buf, 0, 128);
      memcpy(buf, input, input_len < 128 ? input_len : 128);
      u256_from_be(&P1.x, buf);
      u256_from_be(&P1.y, buf + 32);
      u256_from_be(&P2.x, buf + 64);
      u256_from_be(&P2.y, buf + 96);
      P1.inf = u256_is_zero(&P1.x) && u256_is_zero(&P1.y);
      P2.inf = u256_is_zero(&P2.x) && u256_is_zero(&P2.y);
      if (!bn_on_curve(&P1) || !bn_on_curve(&P2)) return 0;
      bn_add_pt(&R, &P1, &P2);
      *out = (uint8_t *)gcalloc(64);
      if (!R.inf) {
        u256_to_be(&R.x, *out);
        u256_to_be(&R.y, *out + 32);
      }
      *out_len = 64;
      return 1;
    }
    case 0x7: {                                                /* bn mul */
      uint8_t buf[96];
      bnpt P, R;
      u256 k;
      if (*gas < 6000) return 0;
      *gas -= 6000;
      memcpy(BNP.w, BNP_W, 32);
      memset(buf, 0, 96);
      memcpy(buf, input, input_len < 96 ? input_len : 96);
      u256_from_be(&P.x, buf);
      u256_from_be(&P.y, buf + 32);
      P.inf = u256_is_zero(&P.x) && u256_is_zero(&P.y);
      if (!bn_on_curve(&P)) return 0;
      u256_from_be(&k, buf + 64);
      bn_mul_pt(&R, &P, &k);
      *out = (uint8_t *)gcalloc(64);
      if (!R.inf) {
        u256_to_be(&R.x, *out);
        u256_to_be(&R.y, *out + 32);
      }
      *out_len = 64;
      return 1;
    }
    case 0x8: {                                                /* pairing */
      uint32_t k, cost;
      int pr;
      if (input_len % 192 != 0) return 0;
      k = input_len / 192;
      cost = 45000 + 34000 * k;
      if (*gas < cost) return 0;
      *gas -= cost;
      pr = bn254_pairing_check(input, input_len);
      if (pr < 0) return 0;
      *out = (uint8_t *)gcalloc(32);
      (*out)[31] = (uint8_t)pr;
      *out_len = 32;
      return 1;
    }
    case 0x9: {                                                /* blake2f */
      uint32_t rounds;
      uint8_t h[64];
      if (input_len != 213) return 0;
      rounds = ((uint32_t)input[0] << 24) | ((uint32_t)input[1] << 16)
               | ((uint32_t)input[2] << 8) | input[3];
      if (*gas < rounds) return 0;
      *gas -= rounds;
      if (input[212] > 1) return 0;
      memcpy(h, input + 4, 64);
      blake2f(rounds, h, input + 68, input + 196, input[212]);
      *out = (uint8_t *)gmalloc(64);
      memcpy(*out, h, 64);
      *out_len = 64;
      return 1;
    }
    case 0x0a: {                                               /* KZG */
      int pr;
      /* EIP-4844 point evaluation over lib/bls381.c. The ceremony's
       * [tau]_2 is compiled into the image (kzg_setup.h, generated by
       * app/guest_input.py from the provisioned host setup); without
       * it the guest cannot validate blocks that call 0x0a. */
      if (!KZG_SETUP_PROVISIONED)
        gpanic("KZG trusted setup not provisioned in this image", 81);
      if (*gas < 50000) return 0;
      *gas -= 50000;
      if (input_len != 192) return 0;
      sha256(input + 96, 48, kzg_vh);
      kzg_vh[0] = 1;
      if (memcmp(kzg_vh, input, 32) != 0) return 0;
      pr = bls_kzg_verify(input + 96, input + 32, input + 64,
                          input + 144, KZG_SETUP_G2);
      if (pr != 1) return 0;
      *out = (uint8_t *)gcalloc(64);
      /* U256(4096) ++ U256(BLS_MODULUS) big-endian */
      (*out)[30] = 0x10;
      {
        static const uint8_t blsmod[32] = {
          0x73, 0xed, 0xa7, 0x53, 0x29, 0x9d, 0x7d, 0x48,
          0x33, 0x39, 0xd8, 0x08, 0x09, 0xa1, 0xd8, 0x05,
          0x53, 0xbd, 0xa4, 0x02, 0xff, 0xfe, 0x5b, 0xfe,
          0xff, 0xff, 0xff, 0xff, 0x00, 0x00, 0x00, 0x01};
        memcpy(*out + 32, blsmod, 32);
      }
      *out_len = 64;
      return 1;
    }
    /* EIP-2537 BLS12-381 suite (Prague, 0x0b..0x11). Curve math runs
     * in lib/bls381.c over the SYS_BIGINT accelerator; gas mirrors the
     * host engine's tables (app/csrc/evm.cpp). The map-to-curve pair
     * (0x10/0x11) needs the SSWU isogeny constants, which are not
     * available in this build environment — fault loudly. */
    case 0x0b: case 0x0c: case 0x0d: case 0x0e:
    case 0x0f: case 0x10: case 0x11: {
      uint32_t need = 0;
      uint32_t olen = 0;
      if (id == 0x0b) {
        if (input_len != 256) return 0;
        need = 375;
      } else if (id == 0x0c) {
        if (input_len == 0 || input_len % 160) return 0;
        need = bls_msm_gas(input_len / 160, 12000, 0);
      } else if (id == 0x0d) {
        if (input_len != 512) return 0;
        need = 600;
      } else if (id == 0x0e) {
        if (input_len == 0 || input_len % 288) return 0;
        need = bls_msm_gas(input_len / 288, 22500, 1);
      } else if (id == 0x0f) {
        if (input_len == 0 || input_len % 384) return 0;
        need = 32600u * (input_len / 384) + 37700u;
      } else if (id == 0x10) {
        /* 0x10/0x11: malformed input or out-of-gas is an ordinary
         * precompile failure (mirrors the host's check order); only a
         * funded, well-formed call reaches the unsupported
         * map-to-curve backend, which both sides fail hard on
         * (host: engine error -> block rejected) */
        if (input_len != 64) return 0;
        need = 5500;
      } else {
        if (input_len != 128) return 0;
        need = 23800;
      }
      if (*gas < need) return 0;
      *gas -= need;
      if (id >= 0x10)
        gpanic("BLS map-to-curve precompile unsupported", 141);
      *out = (uint8_t *)gcalloc(256);
      if (bls_eip2537((int)(id - 0x0b), input, input_len, *out,
                      &olen) != 1) {
        *out = 0;
        return 0;
      }
      *out_len = olen;
      return 1;
    }
      return 0;
  }
  return 0;
}

/* -- exec_tx (evm_exec_tx port) ---------------------------------------------- */

int gevm_exec_tx(const txctx *c, uint32_t *out_gas_used) {
  const uint8_t *from = c->from;
  const uint8_t *to = c->to;
  const u256 *value = &c->value;
  uint32_t gas_limit = c->gas_limit;
  const u256 *eff_gas_price = &c->eff_gas_price;
  const u256 *tip_per_gas = &c->tip_per_gas;
  const uint8_t *data = c->data;
  uint32_t data_len = c->data_len;
  const uint8_t *access_list = c->access_list;
  uint32_t acl_len = c->acl_len;
  const uint8_t *blob_hashes = c->blob_hashes;
  uint32_t n_blobs = c->n_blobs;
  const u256 *blob_fee = &c->blob_fee;
  uint32_t tx_nonce = c->tx_nonce;
  uint32_t intrinsic, i, gas, floor_gas;
  gacct *sacc;
  callres cr;
  uint32_t is_create = to == 0;

  gs_begin_tx();
  memcpy(ENV.origin, from, 20);
  ENV.gas_price = *eff_gas_price;
  ENV.n_blob_hashes = n_blobs > 8 ? 8 : n_blobs;
  for (i = 0; i < ENV.n_blob_hashes; i++)
    u256_from_be(&ENV.blob_hashes[i], blob_hashes + 32 * i);

  intrinsic = 21000u + (is_create ? 32000u : 0u);
  for (i = 0; i < data_len; i++)
    intrinsic += data[i] ? 16u : 4u;
  if (is_create) intrinsic += 2u * ((data_len + 31u) / 32u);
  {
    uint32_t off = 0;
    while (off + 24 <= acl_len) {
      uint32_t ns = (uint32_t)access_list[off + 20]
                    | ((uint32_t)access_list[off + 21] << 8)
                    | ((uint32_t)access_list[off + 22] << 16)
                    | ((uint32_t)access_list[off + 23] << 24);
      intrinsic += 2400u;
      off += 24;
      intrinsic += 1900u * ns;
      off += 32u * ns;
    }
  }
  if (c->n_auth && !ENV.is_prague) return -1;
  /* EIP-7702: 25000/tuple. Guard the uint32 product (the host computes
   * in 64-bit): any tuple count that would overflow also certainly
   * exceeds the block gas limit -> invalid either way. */
  if (c->n_auth > gas_limit / 25000u) return -1;
  intrinsic += 25000u * c->n_auth;
  if (intrinsic > gas_limit) return -1;
  /* EIP-7623 calldata floor (Prague) */
  floor_gas = 0;
  if (ENV.is_prague) {
    uint32_t tokens = 0;
    for (i = 0; i < data_len; i++) tokens += data[i] ? 4u : 1u;
    floor_gas = 21000u + 10u * tokens;
    if (floor_gas > gas_limit) return -1;
  }

  sacc = gs_account(from);
  if (sacc->nonce != tx_nonce) return -1;
  {
    u256 upfront, gl, t;
    u256_from_u32(&gl, gas_limit);
    u256_mul(&t, &gl, eff_gas_price);
    u256_add(&upfront, &t, value);
    u256_add(&upfront, &upfront, blob_fee);
    if (u256_cmp(&sacc->balance, &upfront) < 0) return -1;
    u256_add(&t, &t, blob_fee);
    u256_sub(&t, &sacc->balance, &t);
    gs_set_balance(sacc, &t);
  }
  gs_set_nonce(sacc, sacc->nonce + 1);

  /* warm sets */
  gs_warm_account(sacc);
  gs_warm_account(gs_account(ENV.coinbase));
  for (i = 1; i <= (ENV.is_prague ? 0x11u : 0x0au); i++) {
    uint8_t p[20];
    memset(p, 0, 20);
    p[19] = (uint8_t)i;
    gs_warm_account(gs_account(p));
  }
  {
    uint32_t off = 0;
    while (off + 24 <= acl_len) {
      gacct *aa = gs_account(access_list + off);
      uint32_t ns = (uint32_t)access_list[off + 20]
                    | ((uint32_t)access_list[off + 21] << 8)
                    | ((uint32_t)access_list[off + 22] << 16)
                    | ((uint32_t)access_list[off + 23] << 24);
      uint32_t k;
      gs_warm_account(aa);
      off += 24;
      for (k = 0; k < ns && off + 32 <= acl_len; k++) {
        gs_warm_slot(aa, access_list + off);
        off += 32;
      }
    }
  }

  /* EIP-7702 authorization processing (after the sender nonce bump,
   * before execution; invalid tuples are skipped, not fatal) */
  if (c->n_auth && ENV.is_prague) {
    /* secp256k1 N/2 (EIP-2 malleability bound for auth signatures) */
    static const uint8_t HALF_N_BE[32] = {
      0x7f, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
      0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
      0x5d, 0x57, 0x6e, 0x73, 0x57, 0xa4, 0x50, 0x1d,
      0xdf, 0xe9, 0x2f, 0x46, 0x68, 0x1b, 0x20, 0xa0};
    rlp_t auth;
    const uint8_t *cur = 0;
    rlp_t entry;
    memset(&auth, 0, sizeof(auth));
    auth.p = c->auth_rlp;
    auth.len = c->auth_rlp_len;
    auth.is_list = 1;
    while (rlp_next(&auth, &cur, &entry)) {
      rlp_t it;
      u256 a_chain, sig_r, sig_s, half_n;
      uint32_t a_nonce, yp, nonce_fits;
      uint8_t a_addr[20];
      uint8_t digest[32];
      uint8_t authority[20];
      const uint8_t *pre_end;
      gacct *aacc;
      uint8_t *acode;
      uint32_t acl2;
      if (!entry.is_list || rlp_count(&entry) != 6) continue;
      rlp_at(&entry, 0, &it);
      rlp_u256(&it, &a_chain);
      rlp_at(&entry, 1, &it);
      if (it.len != 20) continue;
      memcpy(a_addr, it.p, 20);
      rlp_at(&entry, 2, &it);
      if (it.len > 8) continue;               /* nonce is u64 per EIP */
      if (it.len == 8) {                      /* nonce == 2^64-1 check */
        uint32_t k2, allff = 1;
        for (k2 = 0; k2 < 8; k2++)
          if (it.p[k2] != 0xFF) allff = 0;
        if (allff) continue;                  /* pre-recovery, as host */
      }
      /* accounts here carry u32 nonces; a larger tuple nonce can never
       * match — but the host still recovers + WARMS the authority
       * before the nonce check, so mirror that ordering */
      nonce_fits = it.len <= 4;
      a_nonce = nonce_fits ? rlp_u32(&it) : 0;
      pre_end = it.raw + it.raw_len;          /* end of [chain,addr,nonce] */
      rlp_at(&entry, 3, &it);
      yp = rlp_u32(&it);
      rlp_at(&entry, 4, &it);
      rlp_u256(&it, &sig_r);
      rlp_at(&entry, 5, &it);
      rlp_u256(&it, &sig_s);
      if (!u256_is_zero(&a_chain)) {
        if (!u256_fits_u32(&a_chain)
            || u256_low_u32(&a_chain) != ENV.chain_id)
          continue;
      }
      if (yp > 1) continue;
      u256_from_be(&half_n, HALF_N_BE);
      if (u256_cmp(&sig_s, &half_n) > 0) continue;
      /* authority = ecrecover(keccak(0x05 || rlp([chain, addr, nonce])));
       * the signed payload is the raw slice of the entry's first three
       * items (no re-encoding — exact for any int widths) */
      {
        uint8_t msg[96];
        rlpw_t w;
        uint32_t mark;
        uint32_t plen = (uint32_t)(pre_end - entry.p);
        if (plen > 88) continue;
        msg[0] = 0x05;
        rlpw_init(&w, msg + 1, 95);
        mark = rlpw_list_begin(&w);
        rlpw_raw(&w, entry.p, plen);
        rlpw_list_end(&w, mark);
        keccak256(msg, 1 + w.len, digest);
      }
      if (!secp_ecrecover(digest, yp, &sig_r, &sig_s, authority)) continue;
      aacc = gs_account(authority);
      gs_warm_account(aacc);
      acode = gs_code(aacc, &acl2);
      if (acl2 != 0 && !is_delegation(acode, acl2)) continue;
      if (!nonce_fits || aacc->nonce != a_nonce) continue;
      if (aacc->exists
          && !(aacc->nonce == 0 && u256_is_zero(&aacc->balance)
               && acl2 == 0))
        gs_add_refund(25000u - 12500u, 0);
      {
        uint32_t zero = 1;
        for (i = 0; i < 20; i++)
          if (a_addr[i]) zero = 0;
        if (zero) {
          static uint8_t no_code[1];
          gs_set_code(aacc, no_code, 0);
        } else {
          uint8_t *d = (uint8_t *)gmalloc(23);
          d[0] = 0xef;
          d[1] = 0x01;
          d[2] = 0x00;
          memcpy(d + 3, a_addr, 20);
          gs_set_code(aacc, d, 23);
        }
      }
      if (!aacc->exists) gs_mark_created(aacc);
      gs_set_nonce(aacc, aacc->nonce + 1);
    }
  }

  gas = gas_limit - intrinsic;
  memset(&cr, 0, sizeof(cr));
  if (is_create) {
    uint8_t created[20];
    u256 zsalt;
    createargs ca;
    u256_zero(&zsalt);
    ca.caller = from;
    ca.value = value;
    ca.initcode = data;
    ca.initcode_len = data_len;
    ca.is_create2 = 0;
    ca.salt = &zsalt;
    create_frame(&ca, gas, 1, created, &cr);
  } else {
    gacct *tacc = gs_account(to);
    uint32_t snap;
    gs_warm_account(tacc);
    snap = gs_snapshot();
    if (u256_cmp(&sacc->balance, value) < 0) {
      cr.success = 0;
      cr.gas_left = gas;
    } else {
      u256 nb;
      u256_sub(&nb, &sacc->balance, value);
      gs_set_balance(sacc, &nb);
      if (!tacc->exists && !u256_is_zero(value)) gs_mark_created(tacc);
      u256_add(&nb, &tacc->balance, value);
      gs_set_balance(tacc, &nb);
      {
        uint32_t handled = 0, pgas = gas;
        uint8_t *pout = 0;
        uint32_t pout_len = 0;
        uint32_t psucc = precompile(to, data, data_len, &pgas, &pout,
                                    &pout_len, &handled);
        if (handled && psucc) {
          cr.success = 1;
          cr.gas_left = pgas;
        } else if (handled) {
          cr.success = 0;
          cr.gas_left = 0;
        } else {
          gframe frame;
          uint32_t cl;
          uint8_t *tc;
          uint32_t dlg_oog = 0;
          memset(&frame, 0, sizeof(frame));
          memcpy(frame.address, to, 20);
          memcpy(frame.caller, from, 20);
          frame.value = *value;
          frame.input = data;
          frame.input_len = data_len;
          tc = gs_code(tacc, &cl);
          if (ENV.is_prague && is_delegation(tc, cl)) {
            /* EIP-7702: top-level execution follows the designator */
            gacct *dacc = gs_account(tc + 3);
            uint32_t need = gs_warm_account(dacc) ? G_WARM : G_COLD_ACCOUNT;
            if (need > gas) dlg_oog = 1;
            else {
              gas -= need;
              tc = gs_code(dacc, &cl);
            }
          }
          frame.code = tc;
          frame.code_len = cl;
          if (dlg_oog) {
            cr.success = 0;
            cr.gas_left = 0;
          } else {
            call_frame(&frame, gas, 1, &cr);
          }
        }
      }
      if (!cr.success) gs_revert(snap);
    }
  }

  {
    uint32_t used = gas_limit - cr.gas_left;
    uint32_t refund = gs_refund();
    if (refund > used / 5u) refund = used / 5u;
    if (cr.success) used -= refund;
    if (used < floor_gas) used = floor_gas;  /* EIP-7623 calldata floor */
    {
      u256 t, amt;
      u256_from_u32(&t, gas_limit - used);
      u256_mul(&amt, &t, eff_gas_price);
      u256_add(&amt, &sacc->balance, &amt);
      gs_set_balance(sacc, &amt);
    }
    {
      gacct *cb = gs_account(ENV.coinbase);
      u256 t, amt;
      u256_from_u32(&t, used);
      u256_mul(&amt, &t, tip_per_gas);
      u256_add(&amt, &cb->balance, &amt);
      gs_set_balance(cb, &amt);
    }
    gs_end_tx();
    *out_gas_used = used;
  }
  return cr.success ? 1 : 0;
}

void gevm_system_call(const uint8_t to[20], const uint8_t *data,
                      uint32_t data_len) {
  gacct *tacc = gs_account(to);
  uint32_t cl;
  uint8_t *code = gs_code(tacc, &cl);
  static const uint8_t SYS[20] = {0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                                  0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                                  0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                                  0xff, 0xfe};
  if (cl == 0) return;
  gs_begin_tx();
  memcpy(ENV.origin, SYS, 20);
  u256_zero(&ENV.gas_price);
  {
    gframe frame;
    callres cr;
    uint32_t snap = gs_snapshot();
    memset(&frame, 0, sizeof(frame));
    memcpy(frame.address, to, 20);
    memcpy(frame.caller, SYS, 20);
    frame.input = data;
    frame.input_len = data_len;
    frame.code = code;
    frame.code_len = cl;
    call_frame(&frame, 30000000, 1, &cr);
    if (!cr.success) gs_revert(snap);
  }
  gs_end_tx();
}

int gevm_system_call_out(const uint8_t to[20], const uint8_t *data,
                         uint32_t data_len, uint8_t **out) {
  gacct *tacc = gs_account(to);
  uint32_t cl;
  uint8_t *code = gs_code(tacc, &cl);
  int n = -2;
  static const uint8_t SYS[20] = {0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                                  0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                                  0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                                  0xff, 0xfe};
  *out = 0;
  if (cl == 0) return -1;
  gs_begin_tx();
  memcpy(ENV.origin, SYS, 20);
  u256_zero(&ENV.gas_price);
  {
    gframe frame;
    callres cr;
    uint32_t snap = gs_snapshot();
    memset(&frame, 0, sizeof(frame));
    memcpy(frame.address, to, 20);
    memcpy(frame.caller, SYS, 20);
    frame.input = data;
    frame.input_len = data_len;
    frame.code = code;
    frame.code_len = cl;
    call_frame(&frame, 30000000, 1, &cr);
    if (!cr.success) {
      gs_revert(snap);
    } else {
      *out = cr.out;
      n = (int)cr.out_len;
    }
  }
  gs_end_tx();
  if (n == -2) gpanic("request system call failed", 140);
  return n;
}
