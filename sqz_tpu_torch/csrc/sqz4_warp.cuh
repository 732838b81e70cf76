// The warp primitives of the redesigned coder kernels, behind one shim.
//
// On the card a warp of kLanes = 32 threads runs a block's producer or
// coder: every lane computes the same serial state (so a warp's lanes
// never diverge; one lane stores to device memory), and the lanes split
// only the work that is parallel (staging loads, reciprocals, table
// setup) as `for (i = lane_id(); i < n; i += kLanes)`. A read-modify-write
// of shared memory puts a warp_sync() between the lanes' reads and their
// (equal) writes. Two warps of a CTA hand buffers over through named
// barriers.
// A host C++ compiler (the host tests) sees one lane (kLanes = 1, lane 0),
// no-op syncs and no barriers: the same code then runs the producer and
// the coder one after the other in one thread and computes the same
// bytes. A host includer that defines SQZ_HOST_WARP supplies these
// primitives itself (tests/test_torch_csrc_host.py runs a warp of 32
// host threads that way).
#pragma once

#include <stdint.h>

#ifndef SQZ_DEVICE
#define SQZ_DEVICE __device__ __forceinline__
#endif

// loop unrolling for nvcc (a host compiler unrolls on its own)
#ifdef __CUDACC__
#define SQZ_PRAGMA(x) _Pragma(#x)
#define SQZ_UNROLL(...) SQZ_PRAGMA(unroll __VA_ARGS__)
#else
#define SQZ_UNROLL(...)
#endif

namespace sqz4 {

#ifdef __CUDACC__
constexpr int kLanes = 32;
SQZ_DEVICE int lane_id() { return threadIdx.x & 31; }
SQZ_DEVICE void warp_sync() { __syncwarp(); }
// Named barrier `id` (1..15) over `threads` threads (whole warps): wait
// for all of them, or only count this warp in.
SQZ_DEVICE void bar_wait(int id, int threads) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
SQZ_DEVICE void bar_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
// lane src's v; the sum of v over the lanes
SQZ_DEVICE int shfl(int v, int src) {
    return __shfl_sync(0xffffffffu, v, src);
}
SQZ_DEVICE int warp_sum(int v) {
    return static_cast<int>(__reduce_add_sync(0xffffffffu,
                                              static_cast<unsigned>(v)));
}
// the sum of v over the lanes below this one
SQZ_DEVICE int warp_exscan(int v) {
    int x = v;
    SQZ_UNROLL()
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        x += (threadIdx.x & 31) >= d ? y : 0;
    }
    return x - v;
}
// *p += v in shared memory, atomically among the lanes
SQZ_DEVICE void smem_add(int* p, int v) { atomicAdd(p, v); }
SQZ_DEVICE uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }
// bit l set for each lane l whose p holds
SQZ_DEVICE unsigned ballot(bool p) { return __ballot_sync(0xffffffffu, p); }
SQZ_DEVICE int popc(unsigned x) { return __popc(x); }
// the lowest set lane of x, kLanes if none
SQZ_DEVICE int lowest(unsigned x) { return x ? __ffs(x) - 1 : kLanes; }
#elif !defined(SQZ_HOST_WARP)   // else the includer defines these
constexpr int kLanes = 1;
SQZ_DEVICE int lane_id() { return 0; }
SQZ_DEVICE void warp_sync() {}
SQZ_DEVICE void bar_wait(int, int) {}
SQZ_DEVICE void bar_arrive(int, int) {}
SQZ_DEVICE int shfl(int v, int) { return v; }
SQZ_DEVICE int warp_sum(int v) { return v; }
SQZ_DEVICE int warp_exscan(int) { return 0; }
SQZ_DEVICE void smem_add(int* p, int v) { *p += v; }
SQZ_DEVICE uint32_t bswap32(uint32_t x) { return __builtin_bswap32(x); }
SQZ_DEVICE unsigned ballot(bool p) { return p; }
SQZ_DEVICE int popc(unsigned x) { return __builtin_popcount(x); }
SQZ_DEVICE int lowest(unsigned x) { return x ? __builtin_ctz(x) : kLanes; }
#endif

// the lanes below lane k (0 <= k <= 32)
SQZ_DEVICE unsigned below(int k) { return k >= 32 ? ~0u : (1u << k) - 1u; }

}  // namespace sqz4
