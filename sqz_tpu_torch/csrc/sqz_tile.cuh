// Tiles of the lane-interleaved column layout.
//
// Every encoder of the port writes its per-block columns as [rows, lanes]
// u32: lane b's element r lies at r * lanes + b, so one lane's column is
// strided by the lane count, and a warp that walks one column touches a
// 32-byte sector for each 4 bytes it uses. The bit-packer
// (squeeze_bitpack.cu) and the payload compaction (sqz4_compact.cu)
// instead take a tile of kLanes = 32 adjacent lanes x some rows, so that
// each row of the tile is one 128-byte line that one warp loads or
// stores, coalesced. The bit-packer keeps a thread's rows in registers;
// the compaction stages the tile into shared memory, kPitch = 33 words a
// row (stage). The pad word makes a column of the staged tile
// conflict-free to read: lane j of a warp reading rows r0 + j of column c
// hits bank (r0 + j + c) mod 32, so the staged tile read by column is the
// transpose for free.
//
// What a host compiler sees: the constants and atomic_or (a plain |= on
// a host, where the harnesses give each word one writer at a time); the
// staging (cp.async) is device code.
#pragma once

#include <stdint.h>

#ifndef SQZ_DEVICE
#define SQZ_DEVICE __device__ __forceinline__
#endif

namespace sqz_tile {

constexpr int kLanes = 32;            // lanes of a tile: one 128-byte row
constexpr int kPitch = kLanes + 1;    // staged words a row (one pad word)

#ifdef __CUDACC__

// *p |= v in shared or device memory, atomically among threads
SQZ_DEVICE void atomic_or(uint32_t* p, uint32_t v) { atomicOr(p, v); }

SQZ_DEVICE void cp_async4(uint32_t* dst, const uint32_t* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
                 "l"(src)
                 : "memory");
}

// Stage rows [0, kRows) of a tile: src points at lane 0 of the tile's
// first row, rows `stride` words apart; dst gets element (r, l) at
// r * kPitch + l. A thread's lane is threadIdx.x % 32, so each warp copies
// whole rows; element (r, l) is copied when r < lim, the limit this
// thread passes for its lane, and zero-filled otherwise. The copies are
// cp.async: the caller waits with stage_wait() and then syncs the CTA.
template <int kThreads, int kRows>
SQZ_DEVICE void stage(const uint32_t* src, long long stride, int lim,
                      uint32_t* dst) {
    constexpr int kWarps = kThreads / 32;
    static_assert(kRows % kWarps == 0, "whole rows a warp");
    const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < kRows / kWarps; ++i) {
        const int r = w + i * kWarps;
        uint32_t* d = dst + r * kPitch + l;
        if (r < lim)
            cp_async4(d, src + r * stride + l);
        else
            *d = 0u;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
}

SQZ_DEVICE void stage_wait() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

#else

SQZ_DEVICE void atomic_or(uint32_t* p, uint32_t v) { *p |= v; }

#endif  // __CUDACC__

}  // namespace sqz_tile
