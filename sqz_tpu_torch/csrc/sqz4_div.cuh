// Exact division of a u64 by a model total, without a divide instruction.
//
// The sqz4 coders divide the 64-bit range by a model total on every coded
// symbol, and every total stays below 2^17 (64 KiB blocks at most). Hopper
// has no integer divider: `/` on u64 compiles to a long software routine,
// and on a coder's serial chain that routine set the pace. Here the
// quotient is one high multiply by a precomputed reciprocal and one
// correction:
//
//   m = recip64(d) = floor((2^64 - 1) / d)          (off the chain)
//   q = div_by(n, d, m) = floor(n / d)              (on the chain)
//     = mulhi64(n, m) + div_up(n, d, mulhi64(n, m))
//
// Why div_by is exact: m*d lies in [2^64 - d, 2^64 - 1], so
// n/d - n*m/2^64 = n (2^64 - m d) / (d 2^64) lies in [0, n / 2^64) c [0, 1),
// and umulhi(n, m) = floor(n*m / 2^64) is floor(n/d) or one less; the
// remainder test adds the missing one. The subtraction cannot wrap since
// q*d <= n.
//
// recip64 computes m without an integer divide either: a correctly rounded
// fp64 reciprocal (H100 runs fp64 at full rate) gives 2^64/d to 53 bits,
// the exact residual (2^64 - 1) - m0*d (a few multiples of d, in two's
// complement) is divided by the same reciprocal, and one step each way
// fixes the rounding. It runs where a total changes, ahead of the symbol
// that divides by it. tests/test_torch_csrc_host.py checks both functions
// against Python's // for every divisor 1..2^17-1.
//
// The device intrinsics have host counterparts with the same results, so
// a host C++ compiler builds this header too (the host tests).
#pragma once

#include <math.h>
#include <stdint.h>

#ifndef SQZ_DEVICE
#define SQZ_DEVICE __device__ __forceinline__
#endif

namespace sqz4 {

typedef unsigned long long u64;

// floor(a * b / 2^64)
SQZ_DEVICE u64 mulhi64(u64 a, u64 b) {
#ifdef __CUDACC__
    return __umul64hi(a, b);
#else
    return static_cast<u64>((static_cast<unsigned __int128>(a) * b) >> 64);
#endif
}

// 1 / d, correctly rounded
SQZ_DEVICE double rcp_f64(uint32_t d) {
#ifdef __CUDACC__
    return __drcp_rn(static_cast<double>(d));
#else
    return 1.0 / static_cast<double>(d);
#endif
}

// x truncated toward zero (0 <= x < 2^64)
SQZ_DEVICE u64 f64_to_u64(double x) {
#ifdef __CUDACC__
    return __double2ull_rz(x);
#else
    return static_cast<u64>(x);
#endif
}

// floor((2^64 - 1) / d) for 1 <= d < 2^17
SQZ_DEVICE u64 recip64(uint32_t d) {
    const double r = rcp_f64(d);
    // 2^64 / d to 53 bits (d = 1 would overflow: its m is all ones)
    u64 m = d > 1 ? f64_to_u64(r * 18446744073709551616.0) : ~0ull;
    // the residual is below 2^12 * d in magnitude: exact in an int64 and
    // in a double
    long long e = static_cast<long long>(~0ull - m * d);
    const long long c = static_cast<long long>(floor(static_cast<double>(e)
                                                     * r));
    m += static_cast<u64>(c);
    e -= c * static_cast<long long>(d);
    // now -d <= e < 2d
    m += static_cast<u64>(e >= static_cast<long long>(d));
    m -= static_cast<u64>(e < 0);
    return m;
}

// floor(n / d) for 1 <= d < 2^17 is q + div_up(n, d, q) for q =
// mulhi64(n, m), m = recip64(d): a caller may compute with q and q + 1
// while the remainder test runs.
SQZ_DEVICE bool div_up(u64 n, uint32_t d, u64 q) { return n - q * d >= d; }

// floor(n / d) for 1 <= d < 2^17, given m = recip64(d)
SQZ_DEVICE u64 div_by(u64 n, uint32_t d, u64 m) {
    const u64 q = mulhi64(n, m);
    return q + static_cast<u64>(div_up(n, d, q));
}

}  // namespace sqz4
