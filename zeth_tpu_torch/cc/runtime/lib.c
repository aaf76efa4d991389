/* Guest runtime: memory primitives + bump allocator.
 *
 * The libc-subset the stateless-client guest needs (role of the
 * reference guest's `no_std` runtime, SURVEY.md §2.1
 * guests/stateless-client). Word-sized fast paths matter: every cycle
 * is proving cost.
 */
#include <stdint.h>
#include <string.h>
#include <alloc.h>

void *memcpy(void *dst, const void *src, size_t n) {
  uint8_t *d = (uint8_t *)dst;
  const uint8_t *s = (const uint8_t *)src;
  if ((((uint32_t)d | (uint32_t)s) & 3) == 0) {
    while (n >= 16) {
      *(uint32_t *)d = *(const uint32_t *)s;
      *(uint32_t *)(d + 4) = *(const uint32_t *)(s + 4);
      *(uint32_t *)(d + 8) = *(const uint32_t *)(s + 8);
      *(uint32_t *)(d + 12) = *(const uint32_t *)(s + 12);
      d += 16; s += 16; n -= 16;
    }
    while (n >= 4) {
      *(uint32_t *)d = *(const uint32_t *)s;
      d += 4; s += 4; n -= 4;
    }
  }
  while (n) { *d++ = *s++; n--; }
  return dst;
}

void *memmove(void *dst, const void *src, size_t n) {
  uint8_t *d = (uint8_t *)dst;
  const uint8_t *s = (const uint8_t *)src;
  if (d == s || n == 0) return dst;
  if (d < s) return memcpy(dst, src, n);
  d += n;
  s += n;
  while (n) { *--d = *--s; n--; }
  return dst;
}

void *memset(void *dst, int c, size_t n) {
  uint8_t *d = (uint8_t *)dst;
  uint32_t b = (uint32_t)c & 0xFF;
  uint32_t w = b | (b << 8) | (b << 16) | (b << 24);
  if (((uint32_t)d & 3) == 0) {
    while (n >= 16) {
      *(uint32_t *)d = w;
      *(uint32_t *)(d + 4) = w;
      *(uint32_t *)(d + 8) = w;
      *(uint32_t *)(d + 12) = w;
      d += 16; n -= 16;
    }
    while (n >= 4) { *(uint32_t *)d = w; d += 4; n -= 4; }
  }
  while (n) { *d++ = (uint8_t)b; n--; }
  return dst;
}

int memcmp(const void *a, const void *b, size_t n) {
  const uint8_t *x = (const uint8_t *)a;
  const uint8_t *y = (const uint8_t *)b;
  if ((((uint32_t)x | (uint32_t)y) & 3) == 0) {
    while (n >= 4 && *(const uint32_t *)x == *(const uint32_t *)y) {
      x += 4; y += 4; n -= 4;
    }
  }
  while (n) {
    if (*x != *y) return (int)*x - (int)*y;
    x++; y++; n--;
  }
  return 0;
}

size_t strlen(const char *s) {
  size_t n = 0;
  while (s[n]) n++;
  return n;
}

/* heap: [0x0800_0000, ...) — far above the stack (top 0x0400_0000,
 * grows down toward the data section, which the compiler caps at
 * 0x00E0_0000); pages cost cycles only when touched */
#define HEAP_BASE 0x08000000u
static uint32_t heap_next = HEAP_BASE;

void *gmalloc(size_t n) {
  uint32_t p = heap_next;
  heap_next = (heap_next + n + 3u) & ~3u;
  return (void *)p;
}

void *gcalloc(size_t n) {
  void *p = gmalloc(n);
  memset(p, 0, (n + 3u) & ~3u);
  return p;
}

uint32_t heap_used(void) { return heap_next - HEAP_BASE; }
