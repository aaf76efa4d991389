// RV32IM zkVM executor core (ctypes shared library).
//
// Native replacement for the executor/emulator of risc0-circuit-rv32im
// (SURVEY.md §2.2): tight interpreter loop, 4 KiB paged memory with
// paging-cycle accounting, segmentation at 2^po2 cycles, and the zkVM
// syscall ABI documented in ../__init__.py. Witness trace records are
// emitted into a flat uint32 buffer consumed zero-copy by numpy.
//
// Build: make -C . (produces librv32im.so)

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cstdio>
#include <unordered_map>
#include <vector>
#include <memory>

namespace {

// 1 KiB pages, matching the paging circuit's page-tree commitment
// (circuits/paging.py: one 864-row slot per touched page; the full cost
// is charged at first touch — the slot covers both pre and post hashes)
constexpr uint32_t PAGE_BITS = 10;
constexpr uint32_t PAGE_SIZE = 1u << PAGE_BITS;
constexpr uint32_t PAGE_WORDS = PAGE_SIZE / 4;
constexpr uint64_t PAGE_CYCLES = 864;   // paging-circuit rows per page

enum Status : int { ST_RUNNING = 0, ST_HALTED = 1, ST_SEGMENT_FULL = 2, ST_ERROR = 3 };

enum Syscall : uint32_t {
  SYS_HALT = 0, SYS_READ = 1, SYS_COMMIT = 2, SYS_LOG = 3,
  SYS_CYCLE = 4, SYS_KECCAK = 5, SYS_BIGINT = 6, SYS_SHA256 = 7,
};

// Trace record flags (see TRACE_WORDS in __init__.py).
// SYSMEM rows are phantom records emitted after an ecall, one per word of
// syscall IO; the stream tag (bits 8..10) routes them to the in-circuit
// RLC binding chains (input / journal / keccak accelerator IO).
enum TraceFlag : uint32_t {
  TR_MEM_LOAD = 1u << 0, TR_MEM_STORE = 1u << 1, TR_ECALL = 1u << 2,
  TR_SYSMEM = 1u << 3,
};
enum SysmemStream : uint32_t {
  SM_INPUT = 1, SM_JOURNAL = 2, SM_KECCAK_R = 3, SM_KECCAK_W = 4,
  SM_BIGINT_R = 5, SM_BIGINT_W = 6, SM_SHA_R = 7, SM_SHA_W = 8,
};
static inline uint32_t sm_flags(uint32_t stream) {
  return TR_SYSMEM | (stream << 8);
}

struct Page {
  uint32_t words[PAGE_WORDS];
  bool dirty = false;
};

// ---- keccak-f[1600] (for the accelerator syscall) -------------------------
static const uint64_t KECCAK_RC[24] = {
  0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
  0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
  0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
  0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
  0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
  0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
  0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
  0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static inline uint64_t rotl64(uint64_t x, int n) {
  return n ? (x << n) | (x >> (64 - n)) : x;
}

static void keccakf(uint64_t st[25]) {
  static const int ROT[5][5] = {
    {0, 36, 3, 41, 18}, {1, 44, 10, 45, 2}, {62, 6, 43, 15, 61},
    {28, 55, 25, 21, 56}, {27, 20, 39, 8, 14}};
  for (int rnd = 0; rnd < 24; rnd++) {
    uint64_t C[5], D[5], B[25];
    for (int x = 0; x < 5; x++)
      C[x] = st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20];
    for (int x = 0; x < 5; x++) {
      D[x] = C[(x + 4) % 5] ^ rotl64(C[(x + 1) % 5], 1);
      for (int y = 0; y < 5; y++) st[x + 5 * y] ^= D[x];
    }
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        B[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(st[x + 5 * y], ROT[x][y]);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        st[x + 5 * y] = B[x + 5 * y] ^ (~B[(x + 1) % 5 + 5 * y] & B[(x + 2) % 5 + 5 * y]);
    st[0] ^= KECCAK_RC[rnd];
  }
}

// ---- 256-bit modular multiply (for the bigint accelerator syscall) --------
// r = a*b mod m, m != 0. Schoolbook 512-bit product, then binary
// shift-subtract reduction (the executor's job is semantics, not speed —
// the proven batch runs on device via circuits/bigint2.py).
// 384-bit modmul (6 x u64 limbs): r = a * b mod m. Width shared with the
// bigint accelerator circuit (circuits/bigint2.py) and the guest ABI —
// 256-bit users zero-pad their operands.
static void modmul384(const uint64_t a[6], const uint64_t b[6],
                      const uint64_t m[6], uint64_t r[6]) {
  uint64_t p[12] = {0};
  for (int i = 0; i < 6; i++) {
    unsigned __int128 carry = 0;
    for (int j = 0; j < 6; j++) {
      unsigned __int128 cur = (unsigned __int128)a[i] * b[j] + p[i + j] + carry;
      p[i + j] = (uint64_t)cur;
      carry = cur >> 64;
    }
    p[i + 6] += (uint64_t)carry;
  }
  uint64_t rem[6] = {0};
  for (int bit = 767; bit >= 0; bit--) {
    uint64_t over = rem[5] >> 63;
    uint64_t carry = (p[bit / 64] >> (bit % 64)) & 1;
    for (int i = 0; i < 6; i++) {
      uint64_t nc = rem[i] >> 63;
      rem[i] = (rem[i] << 1) | carry;
      carry = nc;
    }
    bool ge = true;
    for (int i = 5; i >= 0; i--)
      if (rem[i] != m[i]) { ge = rem[i] > m[i]; break; }
    if (over || ge) {
      unsigned __int128 borrow = 0;
      for (int i = 0; i < 6; i++) {
        unsigned __int128 cur =
            (unsigned __int128)rem[i] - m[i] - (uint64_t)borrow;
        rem[i] = (uint64_t)cur;
        borrow = (cur >> 64) & 1;
      }
    }
  }
  memcpy(r, rem, 48);
}

// ---- SHA-256 compression (for the accelerator syscall) --------------------
static const uint32_t SHA_K[64] = {
  0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
  0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
  0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
  0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
  0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
  0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
  0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
  0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
  0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
  0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
  0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
static inline uint32_t rotr32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}
static void sha256_compress(const uint32_t st[8], const uint32_t blk[16],
                            uint32_t out[8]) {
  uint32_t w[64];
  memcpy(w, blk, 64);
  for (int t = 16; t < 64; t++) {
    uint32_t s0 = rotr32(w[t - 15], 7) ^ rotr32(w[t - 15], 18) ^ (w[t - 15] >> 3);
    uint32_t s1 = rotr32(w[t - 2], 17) ^ rotr32(w[t - 2], 19) ^ (w[t - 2] >> 10);
    w[t] = w[t - 16] + s0 + w[t - 7] + s1;
  }
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
  for (int t = 0; t < 64; t++) {
    uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + SHA_K[t] + w[t];
    uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  out[0] = st[0] + a; out[1] = st[1] + b; out[2] = st[2] + c;
  out[3] = st[3] + d; out[4] = st[4] + e; out[5] = st[5] + f;
  out[6] = st[6] + g; out[7] = st[7] + h;
}

// ---- executor -------------------------------------------------------------

struct Executor {
  std::unordered_map<uint32_t, std::unique_ptr<Page>> pages;
  // pages touched in the *current segment* (paging cost charged per segment,
  // mirroring the reference's per-segment page-in/page-out accounting)
  std::unordered_map<uint32_t, uint8_t> seg_touched;  // bit0=read bit1=write
  // per-segment data-memory footprint: word addr -> (entry value, exit
  // value). Feeds the circuit's MEMINIT/MEMFIN rows (the RAM argument's
  // segment-boundary lists) — instruction fetches are excluded (they are
  // bound by the program-ROM LogUp instead).
  std::unordered_map<uint32_t, std::pair<uint32_t, uint32_t>> seg_mem;
  // initial image as a map, for the dirty-page fetch consistency check
  std::unordered_map<uint32_t, uint32_t> image_map;

  uint32_t regs[32] = {0};
  uint32_t pc = 0;
  uint32_t exit_code = 0;
  bool halted = false, faulted = false;

  uint64_t user_cycles = 0;
  uint64_t paging_cycles = 0;
  uint64_t seg_start_user = 0;
  uint64_t seg_paging = 0;
  uint64_t keccak_count = 0;
  std::vector<uint64_t> keccak_inputs;  // 25 words per accelerator call
  uint64_t bigint_count = 0;
  std::vector<uint32_t> bigint_inputs;  // 32 words (a|b|m|r) per call
  uint64_t sha_count = 0;
  std::vector<uint32_t> sha_inputs;  // 32 words (state|block|out) per call

  std::vector<uint8_t> input;
  size_t input_pos = 0;
  std::vector<uint8_t> journal;
  std::vector<uint8_t> logbuf;

  bool trace_on = false;
  std::vector<uint32_t> trace;   // records of 8 words

  // initial image (for image-id computation on the Python side)
  std::vector<uint32_t> image_addr_words;  // pairs appended at load

  Page* page(uint32_t pnum) {
    auto it = pages.find(pnum);
    if (it != pages.end()) return it->second.get();
    auto p = std::make_unique<Page>();
    memset(p->words, 0, sizeof(p->words));
    Page* raw = p.get();
    pages.emplace(pnum, std::move(p));
    return raw;
  }

  void touch(uint32_t addr, bool write) {
    uint32_t pnum = addr >> PAGE_BITS;
    uint8_t& bits = seg_touched[pnum];
    uint8_t need = write ? 2 : 1;
    if ((bits & need) == 0) {
      // one paging-circuit slot per touched page, charged at first
      // touch (the slot proves both the pre and post page hashes)
      if (bits == 0) { paging_cycles += PAGE_CYCLES; seg_paging += PAGE_CYCLES; }
      bits |= need | 1;
    }
  }

  uint32_t load_word(uint32_t addr) {
    touch(addr, false);
    Page* p = page(addr >> PAGE_BITS);
    return p->words[(addr & (PAGE_SIZE - 1)) >> 2];
  }

  void store_word(uint32_t addr, uint32_t val) {
    touch(addr, true);
    Page* p = page(addr >> PAGE_BITS);
    p->words[(addr & (PAGE_SIZE - 1)) >> 2] = val;
    p->dirty = true;
  }

  // data accesses (loads/stores/syscall IO) feed the RAM argument's
  // per-segment entry/exit lists; fetches bypass them (ROM-bound)
  void track(uint32_t waddr, uint32_t pre, uint32_t post) {
    auto it = seg_mem.find(waddr);
    if (it == seg_mem.end()) seg_mem.emplace(waddr, std::make_pair(pre, post));
    else it->second.second = post;
  }

  uint32_t data_load_word(uint32_t addr) {
    uint32_t w = load_word(addr);
    track(addr >> 2, w, w);
    return w;
  }

  void data_store_word(uint32_t addr, uint32_t val) {
    uint32_t pre = load_word(addr);
    track(addr >> 2, pre, val);
    store_word(addr, val);
  }

  uint32_t fetch_word(uint32_t addr) {
    uint32_t w = load_word(addr);
    // self-modifying code is outside the proof system's model (fetches
    // are bound to the static program ROM): fault if a dirty page serves
    // a fetch whose word differs from the initial image
    Page* p = page(addr >> PAGE_BITS);
    if (p->dirty) {
      auto it = image_map.find(addr);
      uint32_t img = it == image_map.end() ? 0 : it->second;
      if (img != w) { faulted = true; }
    }
    return w;
  }

  uint8_t load_byte(uint32_t addr) {
    uint32_t w = data_load_word(addr & ~3u);
    return (w >> ((addr & 3) * 8)) & 0xFF;
  }

  void store_byte(uint32_t addr, uint8_t val) {
    uint32_t w = load_word(addr & ~3u);
    uint32_t sh = (addr & 3) * 8;
    data_store_word(addr & ~3u, (w & ~(0xFFu << sh)) | (uint32_t(val) << sh));
  }

  // raw (untracked) byte IO for ELF loading only
  void raw_store_byte(uint32_t addr, uint8_t val) {
    uint32_t w = load_word(addr & ~3u);
    uint32_t sh = (addr & 3) * 8;
    store_word(addr & ~3u, (w & ~(0xFFu << sh)) | (uint32_t(val) << sh));
  }

  uint16_t load_half(uint32_t addr) {
    uint32_t w = data_load_word(addr & ~3u);
    return (w >> ((addr & 2) * 8)) & 0xFFFF;
  }

  void store_half(uint32_t addr, uint16_t val) {
    uint32_t w = load_word(addr & ~3u);
    uint32_t sh = (addr & 2) * 8;
    data_store_word(addr & ~3u, (w & ~(0xFFFFu << sh)) | (uint32_t(val) << sh));
  }

  void read_bytes(uint32_t addr, uint8_t* dst, uint32_t len) {
    for (uint32_t i = 0; i < len; i++) dst[i] = load_byte(addr + i);
  }

  // untracked reads for SYS_LOG (no claim-relevant effect, no trace rows)
  void log_read_bytes(uint32_t addr, uint8_t* dst, uint32_t len) {
    for (uint32_t i = 0; i < len; i++) {
      uint32_t w = load_word((addr + i) & ~3u);
      dst[i] = (w >> (((addr + i) & 3) * 8)) & 0xFF;
    }
  }

  void emit_trace(uint32_t ins_pc, uint32_t insn, uint32_t rs1v, uint32_t rs2v,
                  uint32_t rdv, uint32_t maddr, uint32_t mval, uint32_t flags) {
    if (!trace_on) return;
    trace.push_back(ins_pc); trace.push_back(insn);
    trace.push_back(rs1v); trace.push_back(rs2v); trace.push_back(rdv);
    trace.push_back(maddr); trace.push_back(mval); trace.push_back(flags);
  }

  // Pending SYSMEM phantom rows (flushed right after the ecall's own
  // trace record): [addr, value, flags] per word of syscall IO.
  std::vector<std::array<uint32_t, 3>> pending_sysmem;

  void push_sysmem(uint32_t addr, uint32_t val, uint32_t stream) {
    pending_sysmem.push_back({addr, val, sm_flags(stream)});
  }

  void ecall(uint32_t next_pc) {
    uint32_t num = regs[17];  // a7
    uint32_t a0 = regs[10], a1 = regs[11];
    (void)next_pc;
    switch (num) {
      case SYS_HALT:
        exit_code = a0;
        halted = true;
        break;
      case SYS_READ: {
        // word-aligned ABI: buffers and lengths are word multiples so the
        // in-circuit input binding is a clean word stream
        if ((a0 & 3) || (a1 & 3)) { faulted = true; break; }
        uint32_t n = a1;
        size_t avail = input.size() - input_pos;
        if (n > avail) n = (uint32_t)avail;
        if (n & 3) { faulted = true; break; }  // env pads input to words
        for (uint32_t off = 0; off < n; off += 4) {
          uint32_t w;
          memcpy(&w, input.data() + input_pos + off, 4);
          data_store_word(a0 + off, w);
          push_sysmem(a0 + off, w, SM_INPUT);
        }
        input_pos += n;
        regs[10] = n;
        break;
      }
      case SYS_COMMIT: {
        if ((a0 & 3) || (a1 & 3)) { faulted = true; break; }
        for (uint32_t off = 0; off < a1; off += 4) {
          uint32_t w = data_load_word(a0 + off);
          push_sysmem(a0 + off, w, SM_JOURNAL);
          journal.insert(journal.end(), (uint8_t*)&w, (uint8_t*)&w + 4);
        }
        break;
      }
      case SYS_LOG: {
        std::vector<uint8_t> buf(a1);
        log_read_bytes(a0, buf.data(), a1);
        logbuf.insert(logbuf.end(), buf.begin(), buf.end());
        break;
      }
      case SYS_CYCLE:
        regs[10] = (uint32_t)user_cycles;
        break;
      case SYS_KECCAK: {
        if (a0 & 3) { faulted = true; break; }
        uint64_t st[25];
        uint32_t words[50];
        for (uint32_t i = 0; i < 50; i++) {
          words[i] = data_load_word(a0 + 4 * i);
          push_sysmem(a0 + 4 * i, words[i], SM_KECCAK_R);
        }
        memcpy(st, words, 200);
        keccak_inputs.insert(keccak_inputs.end(), st, st + 25);
        keccakf(st);
        memcpy(words, st, 200);
        for (uint32_t i = 0; i < 50; i++) {
          data_store_word(a0 + 4 * i, words[i]);
          push_sysmem(a0 + 4 * i, words[i], SM_KECCAK_W);
        }
        keccak_count++;
        break;
      }
      case SYS_BIGINT: {
        // a0 -> 4 x 48-byte little-endian region [a | b | m | r]; the
        // executor reads a,b,m, writes r = a*b mod m, and records the
        // claim for the accelerator batch (circuits/bigint2.py).
        // 384-bit width (BLS12-381-capable); 256-bit users zero-pad.
        if (a0 & 3) { faulted = true; break; }
        uint32_t words[48];
        for (uint32_t i = 0; i < 36; i++)
          words[i] = data_load_word(a0 + 4 * i);
        uint64_t A[6], B[6], M[6], R[6];
        memcpy(A, words, 48); memcpy(B, words + 12, 48);
        memcpy(M, words + 24, 48);
        if (!(M[0] | M[1] | M[2] | M[3] | M[4] | M[5])) {
          faulted = true;
          break;
        }
        for (uint32_t i = 0; i < 36; i++)
          push_sysmem(a0 + 4 * i, words[i], SM_BIGINT_R);
        modmul384(A, B, M, R);
        memcpy(words + 36, R, 48);
        for (uint32_t i = 36; i < 48; i++) {
          data_store_word(a0 + 4 * i, words[i]);
          push_sysmem(a0 + 4 * i, words[i], SM_BIGINT_W);
        }
        bigint_inputs.insert(bigint_inputs.end(), words, words + 48);
        bigint_count++;
        break;
      }
      case SYS_SHA256: {
        // a0 -> [state(8w) | block(16w) | out(8w)]; the executor reads
        // state+block, writes out = compress(state, block), and records
        // the claim for the accelerator batch (circuits/sha256.py).
        if (a0 & 3) { faulted = true; break; }
        uint32_t words[32];
        for (uint32_t i = 0; i < 24; i++) {
          words[i] = data_load_word(a0 + 4 * i);
          push_sysmem(a0 + 4 * i, words[i], SM_SHA_R);
        }
        sha256_compress(words, words + 8, words + 24);
        for (uint32_t i = 24; i < 32; i++) {
          data_store_word(a0 + 4 * i, words[i]);
          push_sysmem(a0 + 4 * i, words[i], SM_SHA_W);
        }
        sha_inputs.insert(sha_inputs.end(), words, words + 32);
        sha_count++;
        break;
      }
      default:
        faulted = true;
    }
  }

  // Execute until halt, fault, or the segment cycle budget is exhausted.
  int run(uint64_t seg_limit) {
    while (!halted && !faulted) {
      uint64_t seg_cycles = (user_cycles - seg_start_user) + seg_paging;
      // reserve: worst-case paging (2 pages) + the largest syscall's
      // SYSMEM rows (keccak: 100 words)
      if (seg_cycles + 2 * PAGE_CYCLES + 128 >= seg_limit)
        return ST_SEGMENT_FULL;

      uint32_t insn = fetch_word(pc);
      if (faulted) return ST_ERROR;
      uint32_t opcode = insn & 0x7F;
      uint32_t rd = (insn >> 7) & 31;
      uint32_t funct3 = (insn >> 12) & 7;
      uint32_t rs1 = (insn >> 15) & 31;
      uint32_t rs2 = (insn >> 20) & 31;
      uint32_t funct7 = insn >> 25;
      uint32_t rs1v = regs[rs1], rs2v = regs[rs2];
      uint32_t next_pc = pc + 4;
      uint32_t rdv = 0; bool wb = false;
      uint32_t maddr = 0, mval = 0, tflags = 0;

      switch (opcode) {
        case 0x37: rdv = insn & 0xFFFFF000u; wb = true; break;              // LUI
        case 0x17: rdv = pc + (insn & 0xFFFFF000u); wb = true; break;       // AUIPC
        case 0x6F: {                                                        // JAL
          int32_t imm = ((int32_t)(insn & 0x80000000) >> 11) |
                        (insn & 0xFF000) | ((insn >> 9) & 0x800) |
                        ((insn >> 20) & 0x7FE);
          rdv = pc + 4; wb = true; next_pc = pc + imm; break;
        }
        case 0x67: {                                                        // JALR
          int32_t imm = (int32_t)insn >> 20;
          rdv = pc + 4; wb = true; next_pc = (rs1v + imm) & ~1u; break;
        }
        case 0x63: {                                                        // branches
          int32_t imm = ((int32_t)(insn & 0x80000000) >> 19) |
                        ((insn << 4) & 0x800) | ((insn >> 20) & 0x7E0) |
                        ((insn >> 7) & 0x1E);
          bool take = false;
          switch (funct3) {
            case 0: take = rs1v == rs2v; break;
            case 1: take = rs1v != rs2v; break;
            case 4: take = (int32_t)rs1v < (int32_t)rs2v; break;
            case 5: take = (int32_t)rs1v >= (int32_t)rs2v; break;
            case 6: take = rs1v < rs2v; break;
            case 7: take = rs1v >= rs2v; break;
            default: faulted = true;
          }
          if (take) next_pc = pc + imm;
          break;
        }
        case 0x03: {                                                        // loads
          int32_t imm = (int32_t)insn >> 20;
          uint32_t addr = rs1v + imm;
          maddr = addr; tflags |= TR_MEM_LOAD;
          // mval records the full aligned word (circuit extracts sub-words)
          switch (funct3) {
            case 0: mval = data_load_word(addr & ~3u);
                    rdv = (int32_t)(int8_t)((mval >> ((addr & 3) * 8)) & 0xFF);
                    break;                                                  // LB
            case 1: if (addr & 1) { faulted = true; break; }
                    mval = data_load_word(addr & ~3u);
                    rdv = (int32_t)(int16_t)((mval >> ((addr & 2) * 8)) & 0xFFFF);
                    break;                                                  // LH
            case 2: if (addr & 3) { faulted = true; break; }
                    mval = data_load_word(addr);
                    rdv = mval; break;                                      // LW
            case 4: mval = data_load_word(addr & ~3u);
                    rdv = (mval >> ((addr & 3) * 8)) & 0xFF; break;         // LBU
            case 5: if (addr & 1) { faulted = true; break; }
                    mval = data_load_word(addr & ~3u);
                    rdv = (mval >> ((addr & 2) * 8)) & 0xFFFF; break;       // LHU
            default: faulted = true;
          }
          wb = true; break;
        }
        case 0x23: {                                                        // stores
          int32_t imm = (((int32_t)insn >> 20) & ~0x1F) | ((insn >> 7) & 0x1F);
          uint32_t addr = rs1v + imm;
          maddr = addr; tflags |= TR_MEM_STORE;
          // mval records the OLD aligned word (circuit checks the merge)
          mval = load_word(addr & ~3u);
          switch (funct3) {
            case 0: store_byte(addr, rs2v & 0xFF); break;                   // SB
            case 1: if (addr & 1) { faulted = true; break; }
                    store_half(addr, rs2v & 0xFFFF); break;                 // SH
            case 2: if (addr & 3) { faulted = true; break; }
                    data_store_word(addr, rs2v); break;                     // SW
            default: faulted = true;
          }
          break;
        }
        case 0x13: {                                                        // op-imm
          int32_t imm = (int32_t)insn >> 20;
          uint32_t shamt = rs2;
          switch (funct3) {
            case 0: rdv = rs1v + imm; break;                                // ADDI
            case 1: rdv = rs1v << shamt; break;                             // SLLI
            case 2: rdv = (int32_t)rs1v < imm; break;                       // SLTI
            case 3: rdv = rs1v < (uint32_t)imm; break;                      // SLTIU
            case 4: rdv = rs1v ^ imm; break;                                // XORI
            case 5: rdv = (funct7 & 0x20) ? (uint32_t)((int32_t)rs1v >> shamt)
                                          : rs1v >> shamt; break;           // SRLI/SRAI
            case 6: rdv = rs1v | imm; break;                                // ORI
            case 7: rdv = rs1v & imm; break;                                // ANDI
          }
          wb = true; break;
        }
        case 0x33: {                                                        // op
          if (funct7 == 1) {                                                // M ext
            uint64_t a = rs1v, b = rs2v;
            int64_t sa = (int32_t)rs1v, sb = (int32_t)rs2v;
            switch (funct3) {
              case 0: rdv = rs1v * rs2v; break;                             // MUL
              case 1: rdv = (uint32_t)(((int64_t)sa * sb) >> 32); break;    // MULH
              case 2: rdv = (uint32_t)(((int64_t)sa * (int64_t)(uint64_t)b) >> 32); break; // MULHSU
              case 3: rdv = (uint32_t)((a * b) >> 32); break;               // MULHU
              case 4: rdv = sb == 0 ? 0xFFFFFFFFu :
                      (sa == INT32_MIN && sb == -1) ? (uint32_t)INT32_MIN :
                      (uint32_t)(sa / sb); break;                           // DIV
              case 5: rdv = rs2v == 0 ? 0xFFFFFFFFu : rs1v / rs2v; break;   // DIVU
              case 6: rdv = sb == 0 ? rs1v :
                      (sa == INT32_MIN && sb == -1) ? 0 :
                      (uint32_t)(sa % sb); break;                           // REM
              case 7: rdv = rs2v == 0 ? rs1v : rs1v % rs2v; break;          // REMU
            }
          } else {
            switch (funct3) {
              case 0: rdv = (funct7 & 0x20) ? rs1v - rs2v : rs1v + rs2v; break;
              case 1: rdv = rs1v << (rs2v & 31); break;                     // SLL
              case 2: rdv = (int32_t)rs1v < (int32_t)rs2v; break;           // SLT
              case 3: rdv = rs1v < rs2v; break;                             // SLTU
              case 4: rdv = rs1v ^ rs2v; break;                             // XOR
              case 5: rdv = (funct7 & 0x20) ? (uint32_t)((int32_t)rs1v >> (rs2v & 31))
                                            : rs1v >> (rs2v & 31); break;   // SRL/SRA
              case 6: rdv = rs1v | rs2v; break;                             // OR
              case 7: rdv = rs1v & rs2v; break;                             // AND
            }
          }
          wb = true; break;
        }
        case 0x0F: break;                                                   // FENCE: nop
        case 0x73:                                                          // SYSTEM
          if (insn == 0x00000073) {
            tflags |= TR_ECALL;
            // the circuit reads a0/a1/a7 through the register argument:
            // record their pre-ecall values in the rs1v/rs2v/maddr fields
            rs1v = regs[10];
            rs2v = regs[11];
            maddr = regs[17];
            ecall(next_pc);
            rdv = regs[10];  // post-syscall a0 (register-file write record)
          } else { faulted = true; }                                        // EBREAK etc.
          break;
        default:
          faulted = true;
      }

      if (faulted) return ST_ERROR;
      if (wb && rd != 0) regs[rd] = rdv;
      uint32_t rec_rdv = (wb && rd != 0) ? rdv : 0;
      if (tflags & TR_ECALL) rec_rdv = rdv;  // a0 after the syscall
      emit_trace(pc, insn, rs1v, rs2v, rec_rdv, maddr, mval, tflags);
      pc = next_pc;
      user_cycles++;
      // flush SYSMEM phantom rows: one row (and one cycle) per IO word
      for (auto& sm : pending_sysmem) {
        emit_trace(next_pc, 0, 0, 0, 0, sm[0], sm[1], sm[2]);
        user_cycles++;
      }
      pending_sysmem.clear();
      if (halted) return ST_HALTED;
    }
    return halted ? ST_HALTED : ST_ERROR;
  }

  void new_segment() {
    seg_start_user = user_cycles;
    seg_paging = 0;
    seg_touched.clear();
    seg_mem.clear();
    trace.clear();
  }
};

// ---- minimal ELF32 loader -------------------------------------------------

struct Elf32Hdr {
  uint8_t ident[16];
  uint16_t type, machine;
  uint32_t version, entry, phoff, shoff, flags;
  uint16_t ehsize, phentsize, phnum, shentsize, shnum, shstrndx;
};

struct Elf32Phdr {
  uint32_t type, offset, vaddr, paddr, filesz, memsz, flags, align;
};

static int load_elf(Executor* ex, const uint8_t* data, size_t len) {
  if (len < sizeof(Elf32Hdr)) return 1;
  Elf32Hdr hdr;
  memcpy(&hdr, data, sizeof(hdr));
  if (memcmp(hdr.ident, "\x7f""ELF", 4) != 0) return 2;
  if (hdr.ident[4] != 1 || hdr.ident[5] != 1) return 3;  // 32-bit LE
  if (hdr.machine != 0xF3) return 4;                     // EM_RISCV
  ex->pc = hdr.entry;
  for (int i = 0; i < hdr.phnum; i++) {
    size_t off = hdr.phoff + (size_t)i * hdr.phentsize;
    if (off + sizeof(Elf32Phdr) > len) return 5;
    Elf32Phdr ph;
    memcpy(&ph, data + off, sizeof(ph));
    if (ph.type != 1) continue;                          // PT_LOAD
    if (ph.offset + ph.filesz > len) return 6;
    for (uint32_t j = 0; j < ph.filesz; j++)
      ex->raw_store_byte(ph.vaddr + j, data[ph.offset + j]);
    // memsz > filesz tail is zero (pages are zero-initialized)
  }
  // record the initial image for image-id computation, then reset counters
  for (auto& kv : ex->pages) {
    kv.second->dirty = false;
    for (uint32_t w = 0; w < PAGE_WORDS; w++) {
      if (kv.second->words[w]) {
        uint32_t addr = (kv.first << PAGE_BITS) + w * 4;
        ex->image_addr_words.push_back(addr);
        ex->image_addr_words.push_back(kv.second->words[w]);
        ex->image_map.emplace(addr, kv.second->words[w]);
      }
    }
  }
  ex->user_cycles = 0;
  ex->paging_cycles = 0;
  ex->new_segment();
  return 0;
}

}  // namespace

extern "C" {

void* ex_create() { return new Executor(); }
void ex_destroy(void* h) { delete (Executor*)h; }

int ex_load_elf(void* h, const char* data, size_t len) {
  return load_elf((Executor*)h, (const uint8_t*)data, len);
}

void ex_set_input(void* h, const char* data, size_t len) {
  Executor* ex = (Executor*)h;
  ex->input.assign(data, data + len);
  ex->input_pos = 0;
}

int ex_run(void* h, uint64_t seg_limit) { return ((Executor*)h)->run(seg_limit); }
void ex_new_segment(void* h) { ((Executor*)h)->new_segment(); }

uint64_t ex_user_cycles(void* h) { return ((Executor*)h)->user_cycles; }
uint64_t ex_paging_cycles(void* h) { return ((Executor*)h)->paging_cycles; }
uint64_t ex_segment_cycles(void* h) {
  Executor* ex = (Executor*)h;
  return (ex->user_cycles - ex->seg_start_user) + ex->seg_paging;
}
uint32_t ex_exit_code(void* h) { return ((Executor*)h)->exit_code; }
void ex_regs(void* h, uint32_t out[32]) {
  memcpy(out, ((Executor*)h)->regs, 32 * sizeof(uint32_t));
}
uint32_t ex_pc(void* h) { return ((Executor*)h)->pc; }
uint64_t ex_keccak_count(void* h) { return ((Executor*)h)->keccak_count; }

size_t ex_journal_len(void* h) { return ((Executor*)h)->journal.size(); }
void ex_journal(void* h, char* out) {
  Executor* ex = (Executor*)h;
  memcpy(out, ex->journal.data(), ex->journal.size());
}
size_t ex_log_len(void* h) { return ((Executor*)h)->logbuf.size(); }
void ex_log(void* h, char* out) {
  Executor* ex = (Executor*)h;
  memcpy(out, ex->logbuf.data(), ex->logbuf.size());
}

void ex_trace_enable(void* h, int on) { ((Executor*)h)->trace_on = on != 0; }

// recorded keccak accelerator inputs: 25 u64 words per call
size_t ex_keccak_inputs_len(void* h) {
  return ((Executor*)h)->keccak_inputs.size();
}
const uint64_t* ex_keccak_inputs(void* h) {
  return ((Executor*)h)->keccak_inputs.data();
}
uint64_t ex_bigint_count(void* h) { return ((Executor*)h)->bigint_count; }
// recorded bigint accelerator claims: 32 u32 words (a|b|m|r) per call
size_t ex_bigint_inputs_len(void* h) {
  return ((Executor*)h)->bigint_inputs.size();
}
const uint32_t* ex_bigint_inputs(void* h) {
  return ((Executor*)h)->bigint_inputs.data();
}
uint64_t ex_sha_count(void* h) { return ((Executor*)h)->sha_count; }
// recorded sha-256 accelerator claims: 32 u32 words (state|block|out)
size_t ex_sha_inputs_len(void* h) {
  return ((Executor*)h)->sha_inputs.size();
}
const uint32_t* ex_sha_inputs(void* h) {
  return ((Executor*)h)->sha_inputs.data();
}
size_t ex_trace_len(void* h) { return ((Executor*)h)->trace.size() / 8; }
uint32_t* ex_trace_data(void* h) { return ((Executor*)h)->trace.data(); }

// per-segment data-memory footprint: (word_addr*4, entry value, exit value)
// triples sorted by address; returns the entry count
size_t ex_segment_mem(void* h, uint32_t* addrs, uint32_t* pre, uint32_t* post,
                      size_t cap) {
  Executor* ex = (Executor*)h;
  size_t n = ex->seg_mem.size();
  if (addrs && pre && post) {
    std::vector<uint32_t> keys;
    keys.reserve(n);
    for (auto& kv : ex->seg_mem) keys.push_back(kv.first);
    std::sort(keys.begin(), keys.end());
    size_t m = n < cap ? n : cap;
    for (size_t i = 0; i < m; i++) {
      auto& pp = ex->seg_mem[keys[i]];
      addrs[i] = keys[i] * 4;
      pre[i] = pp.first;
      post[i] = pp.second;
    }
  }
  return n;
}

// initial memory image as (addr, word) pairs; returns pair count
size_t ex_image_words(void* h, uint32_t* addrs, uint32_t* words, size_t cap) {
  Executor* ex = (Executor*)h;
  size_t n = ex->image_addr_words.size() / 2;
  if (addrs && words) {
    size_t m = n < cap ? n : cap;
    for (size_t i = 0; i < m; i++) {
      addrs[i] = ex->image_addr_words[2 * i];
      words[i] = ex->image_addr_words[2 * i + 1];
    }
  }
  return n;
}

}  // extern "C"
