#ifndef _ZETH_STDDEF_H
#define _ZETH_STDDEF_H
#include <stdint.h>
#define NULL ((void *)0)
#define offsetof(t, m) ((size_t)&(((t *)0)->m))
#endif
