/* Guest stdint.h — 32-bit-only target (zeth-cc has no 64-bit ints). */
#ifndef _ZETH_STDINT_H
#define _ZETH_STDINT_H

typedef unsigned char uint8_t;
typedef signed char int8_t;
typedef unsigned short uint16_t;
typedef short int16_t;
typedef unsigned int uint32_t;
typedef int int32_t;
typedef unsigned int uintptr_t;
typedef int intptr_t;
typedef unsigned int size_t;

#define UINT32_MAX 0xFFFFFFFFu
#define INT32_MAX 0x7FFFFFFF
#define INT32_MIN (-0x7FFFFFFF - 1)

#endif
