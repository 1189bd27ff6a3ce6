// PTX carry-chain primitives for multi-word integer arithmetic: each is one
// instruction that reads and/or writes the condition code's carry flag
// (CC.CF).  `asm volatile` keeps the statements of one chain in program
// order; the compiler emits no other instruction that touches CC.CF.
// Subtraction uses CC.CF as the borrow: subc computes a - b - CF, and
// `subc(0, 0)` after a chain is 0 or 0xffffffff.

#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}

__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}

__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}

__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}

__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}

__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}

// lo(a*b) + c, carry out
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
    uint32_t r;
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;"
                 : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

// lo(a*b) + c + CF, carry out
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
    uint32_t r;
    asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;"
                 : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

// hi(a*b) + c, carry out
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
    uint32_t r;
    asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;"
                 : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

// hi(a*b) + c + CF, carry out
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
    uint32_t r;
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;"
                 : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

}  // namespace
