/* Bump allocator over the guest heap region (no free). */
#ifndef _ZETH_ALLOC_H
#define _ZETH_ALLOC_H
#include <stdint.h>
void *gmalloc(size_t n);
void *gcalloc(size_t n);
uint32_t heap_used(void);
#endif
