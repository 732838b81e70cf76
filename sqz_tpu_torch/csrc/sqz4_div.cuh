// Exact division of a u64 by a model total, without a divide instruction.
//
// The sqz4 coders divide the 64-bit range by a model total on every coded
// symbol. Hopper has no integer divider: `/` on u64 compiles to a long
// software routine, and on a coder's serial chain that routine set the
// pace. Here the quotient is one high multiply by a precomputed
// reciprocal and one correction:
//
//   m = recip64(d) = floor((2^64 - 1) / d)          (off the chain)
//   q = div_by(n, d, m) = floor(n / d)              (on the chain)
//     = mulhi64(n, m) + div_up(n, d, mulhi64(n, m))
//
// The totals these functions meet. The widest block the kernels take is
// 2^kMaxBlockBits bytes, the JAX package's own limit (its scan decoder's
// int32 step budget): the decoder's step budget t_max = 9 * bs + 64
// (ops/sqz4_host.py plan_decode_dispatch) is uint32 there, below 2^32;
// its counts, the meta rows and the coders' row indices and byte counts
// are int32, and each stays below 2^30 at 2^28 bytes. A model total
// starts at 256 at most (cold) or 2^14 at most (a warm seed, rescaled),
// and grows by one a coded symbol of that model; a block of bs bytes codes
// at most bs + 1 symbols with one model (the literal flag: one a token
// plus the end of stream). So every total is below kTotalLimit =
// 2^kMaxBlockBits + 2^14 + 2 < 2^29, and both functions are exact for
// every divisor 1 <= d < 2^32, which holds it with room.
//
// Why div_by is exact, for any d >= 1: m*d lies in [2^64 - d, 2^64 - 1],
// so n/d - n*m/2^64 = n (2^64 - m d) / (d 2^64) lies in [0, n / 2^64) c
// [0, 1), and umulhi(n, m) = floor(n*m / 2^64) is floor(n/d) or one less;
// the remainder test adds the missing one. The subtraction cannot wrap
// since q*d <= n.
//
// recip64 computes m without an integer divide either. r = RN(1/d), the
// correctly rounded fp64 reciprocal (H100 runs fp64 at full rate), has a
// relative error below 2^-53, so m0 = trunc(r * 2^64) is 2^64/d within
// 2^11/d + 1 (2^64/d itself below 2^63 for d > 1; d = 1 is all ones). The
// residual e = (2^64 - 1) - m0*d then lies in [-2^11 - 1, 2^11 + d): an
// int64, exact in a double for d < 2^32. c = floor(e * r) is floor(e/d)
// or one off, since e * r differs from e/d by at most (2^11 + d) 2^-52 / d
// < 2^-20; so m0 + c leaves a residual e - c d in [-d, 2d) (in fact
// [0, d]), and one step each way brings it into [0, d). The bound does not
// loosen as d grows: the first guess only gets closer (2^11/d), and the
// correction's error stays far below one. It runs where a total changes,
// ahead of the symbol that divides by it. tests/test_torch_csrc_host.py
// checks both functions against Python's // for every divisor 1..2^24,
// every divisor within 4096 of each 2^k up to 2^32 and a million random
// ones below 2^32.
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

// the widest block the kernels take, and the bound of every model total
// in it (see above)
constexpr int kMaxBlockBits = 28;
constexpr uint32_t kTotalLimit = (1u << kMaxBlockBits) + (1u << 14) + 2;

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

// floor((2^64 - 1) / d) for 1 <= d < 2^32
SQZ_DEVICE u64 recip64(uint32_t d) {
    const double r = rcp_f64(d);
    // 2^64 / d to 53 bits (d = 1 would overflow: its m is all ones)
    u64 m = d > 1 ? f64_to_u64(r * 18446744073709551616.0) : ~0ull;
    // the residual lies in [-2^11 - 1, 2^11 + d): exact in an int64 and
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

// floor(n / d) for 1 <= d < 2^32 is q + div_up(n, d, q) for q =
// mulhi64(n, m), m = recip64(d): a caller may compute with q and q + 1
// while the remainder test runs.
SQZ_DEVICE bool div_up(u64 n, uint32_t d, u64 q) { return n - q * d >= d; }

// floor(n / d) for any d >= 1, given m = recip64(d)
SQZ_DEVICE u64 div_by(u64 n, uint32_t d, u64 m) {
    const u64 q = mulhi64(n, m);
    return q + static_cast<u64>(div_up(n, d, q));
}

}  // namespace sqz4
