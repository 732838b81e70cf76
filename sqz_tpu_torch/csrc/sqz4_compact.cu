// Ragged payload compaction for Hopper (sm_90a): a tiled transpose.
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
// and the work is a copy. The first design gave each lane a CTA whose
// threads strode the column: lane b's word r lies at r * lanes + b, so a
// warp's 32 loads touched 32 sectors for 128 bytes used.
//
// The design: a CTA takes 32 adjacent lanes and walks tiles of kRows rows
// of them (tiles gridDim.y apart), staging each tile into shared memory as
// coalesced 128-byte rows (sqz_tile.cuh; a thread loads only rows inside
// its lane's payload). One warp then writes one lane's rows of the tile,
// read down the staged column (conflict-free: the pad word), as one
// contiguous run at out + offsets[b] + r. A CTA stops at the longest
// payload of its 32 lanes.

#include <stdint.h>

#include "sqz4_warp.cuh"
#include "sqz_tile.cuh"

namespace sqz4 {

// Copy the first n rows of one lane's column of a staged tile (rows
// `pitch` words apart) to the contiguous dst. A warp's lanes take one row
// each.
SQZ_DEVICE void compact_tile_lane(const uint32_t* col, int pitch, int n,
                                  uint32_t* dst) {
    for (int r = lane_id(); r < n; r += kLanes) dst[r] = col[r * pitch];
}

}  // namespace sqz4

#ifdef __CUDACC__

namespace sqz4 {

constexpr int kCompactThreads = 256;
constexpr int kCompactWarps = kCompactThreads / 32;

template <int kRows>
__global__ void __launch_bounds__(kCompactThreads)
sqz4_compact_kernel(const uint32_t* __restrict__ words, int lanes,
                    const long long* __restrict__ offsets, int nb,
                    uint32_t* __restrict__ out) {
    using sqz_tile::kLanes;
    __shared__ uint32_t tile[kRows * sqz_tile::kPitch];
    __shared__ long long off[kLanes + 1];
    __shared__ int longest;
    const int lane0 = blockIdx.x * kLanes, nl = min(kLanes, nb - lane0);
    const int tid = threadIdx.x, l = tid & 31, warp = tid >> 5;
    if (tid <= nl) off[tid] = offsets[lane0 + tid];
    __syncthreads();
    const int wc = l < nl ? static_cast<int>(off[l + 1] - off[l]) : 0;
    if (warp == 0) {
        const int m = static_cast<int>(__reduce_max_sync(
            0xffffffffu, static_cast<unsigned>(wc)));
        if (tid == 0) longest = m;
    }
    __syncthreads();
    for (int r0 = blockIdx.y * kRows; r0 < longest;
         r0 += gridDim.y * kRows) {
        sqz_tile::stage<kCompactThreads, kRows>(
            words + static_cast<long long>(r0) * lanes + lane0, lanes,
            wc - r0, tile);
        sqz_tile::stage_wait();
        __syncthreads();
        for (int c = warp; c < nl; c += kCompactWarps) {
            const int n = static_cast<int>(off[c + 1] - off[c]) - r0;
            compact_tile_lane(tile + c, sqz_tile::kPitch,
                              n < kRows ? n : kRows, out + off[c] + r0);
        }
        __syncthreads();
    }
}

}  // namespace sqz4

// words: [1, rows, lanes] u32; offsets: [nb + 1] i64 word offsets (lane b
// holds offsets[b + 1] - offsets[b] <= rows words); out: [offsets[nb]]
// u32; tile_rows: 64 or 128. Launches ceil(nb / 32) x (enough to fill the
// card) CTAs on `stream`; returns the cudaError_t of the launch.
extern "C" int sqz4_compact_launch(const void* words, int lanes,
                                   const void* offsets, int nb, void* out,
                                   int tile_rows, void* stream) {
    if (nb == 0) return 0;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int x = (nb + 31) / 32;
    const dim3 grid(x, (4 * sms + x - 1) / x);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* w = static_cast<const uint32_t*>(words);
    const auto* o = static_cast<const long long*>(offsets);
    auto* dst = static_cast<uint32_t*>(out);
    if (tile_rows == 64)
        sqz4::sqz4_compact_kernel<64>
            <<<grid, sqz4::kCompactThreads, 0, s>>>(w, lanes, o, nb, dst);
    else if (tile_rows == 128)
        sqz4::sqz4_compact_kernel<128>
            <<<grid, sqz4::kCompactThreads, 0, s>>>(w, lanes, o, nb, dst);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
