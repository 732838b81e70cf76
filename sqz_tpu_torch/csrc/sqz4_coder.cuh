// Constants and small helpers shared by the sqz4 range-coder kernels
// (FORMAT.md §2.2-§2.3): the encoders' micro-op codes, the decoder's
// states and error codes, and the renormalization shift. The models, the
// coder step and the byte streams are in sqz4_chain.cuh, the encoders'
// two-warp skeleton in sqz4_pair.cuh.
//
// Plain C++ apart from __clzll and the SQZ_DEVICE qualifier, so a host
// compiler builds it too (the host tests).
#pragma once

#include <stdint.h>

#ifndef SQZ_DEVICE
#define SQZ_DEVICE __device__ __forceinline__
#endif

namespace sqz4 {

typedef unsigned long long u64;

// micro-op codes of the encoder's input stream (sqz4_pallas.py:576-577)
constexpr int kOpFlag = 0, kOpSize = 1, kOpByte = 2, kOpBits = 3;
constexpr int kOpDist = 4;   // 4..35: distance bit 0..31
constexpr int kOpFlush = 254;

// decoder states and error codes (sqz4_pallas.py:1647-1648)
constexpr int kFlag = 0, kBitsState = 3, kDistState = 4, kDone = 5,
              kErr = 6;
constexpr int kEIlseq = 1, kESize = 2, kEBits = 3, kEDist = 4,
              kEOverrun = 5;

// Number of leading zero bytes of x (8 for x == 0): the count of equal
// leading bytes of low and low + range, i.e. the renormalization shift.
SQZ_DEVICE int lead_zero_bytes(u64 x) {
    return x ? (__clzll(static_cast<long long>(x)) >> 3) : 8;
}

SQZ_DEVICE u64 shl(u64 x, int s) { return s >= 64 ? 0ull : x << s; }

}  // namespace sqz4
