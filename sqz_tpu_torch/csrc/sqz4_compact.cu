// Ragged payload compaction for Hopper (sm_90a).
//
// Replaces the TPU kernel sqz_tpu/ops/sqz4_pallas.py:_compact_dma_kernel
// (launcher _compact_words_dma): the encoder's payload columns, words
// uint32 [1, rows, lanes] with lane b's payload in the first
// offsets[b + 1] - offsets[b] rows of column b, are packed into one
// contiguous buffer, lane b's words at offsets[b], so the download to the
// host carries the payload bytes and not the rectangle cut at the longest
// lane.
//
// The TPU kernel copies whole 1024-word-aligned columns and lets the next
// lane's copy overwrite the previous pad tail, because Mosaic's DMAs need
// that alignment and its grid runs in order. Neither holds here: CTAs run
// in any order, so every lane writes exactly its own words at a plain word
// offset (a prefix sum of the word counts, computed by the caller), and
// nothing overlaps.
//
// What bounds it: bytes. Each payload word is read once and written once,
// and the work is a copy. The design: one CTA per lane column, its threads
// striding the column's rows, so the writes of a warp are contiguous; the
// reads are strided by the lane count (a shared-memory tiled transpose
// would coalesce them too: later work).

#include <stdint.h>

#ifndef SQZ_DEVICE
#define SQZ_DEVICE __device__ __forceinline__
#endif

namespace sqz4 {

// Copy rows first, first + step, ... below n of one lane's column (rows
// `lanes` elements apart) to the contiguous dst.
SQZ_DEVICE void compact_lane(const uint32_t* col, int lanes, long long n,
                             uint32_t* dst, int first, int step) {
    for (long long r = first; r < n; r += step) dst[r] = col[r * lanes];
}

}  // namespace sqz4

#ifdef __CUDACC__

__global__ void sqz4_compact_kernel(const uint32_t* __restrict__ words,
                                    int lanes,
                                    const long long* __restrict__ offsets,
                                    uint32_t* __restrict__ out) {
    const int b = blockIdx.x;
    const long long start = offsets[b];
    sqz4::compact_lane(words + b, lanes, offsets[b + 1] - start, out + start,
                       threadIdx.x, blockDim.x);
}

// words: [1, rows, lanes] u32; offsets: [nb + 1] i64 word offsets (lane b
// holds offsets[b + 1] - offsets[b] <= rows words); out: [offsets[nb]]
// u32. Launches nb CTAs of `threads` threads on `stream`; returns the
// cudaError_t of the launch.
extern "C" int sqz4_compact_launch(const void* words, int lanes,
                                   const void* offsets, int nb, void* out,
                                   int threads, void* stream) {
    if (nb == 0) return 0;
    sqz4_compact_kernel<<<nb, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), lanes,
        static_cast<const long long*>(offsets), static_cast<uint32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
