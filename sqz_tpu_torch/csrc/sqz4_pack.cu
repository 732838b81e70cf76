// Payload packing for the decoder on Hopper (sm_90a): ragged byte
// strings into the decoder's word columns, a tiled transpose.
//
// Replaces no Pallas kernel. The JAX package packs on the host
// (sqz_tpu/ops/sqz4_pallas.py:pack_decode_chunk and
// sqz_tpu/ops/resident.py:pack_payload_group, through the native
// sqz4_pack_payloads): it zero-fills a [G, pw, lanes] u32 array and ORs
// every payload byte into its big-endian word, lane b's word r at
// r * lanes + b, then the whole padded array is uploaded. At a 512-lane
// group of 64 KiB blocks that array is about 34 MB of fresh pages written
// a byte at a time at a 2 KiB stride, neighbouring lanes (on different
// host threads) writing the same lines on every row: on an H100 host it
// took about 40% of a checkpoint load, with the card idle. Here the
// payloads arrive as one contiguous upload (the bytes back to back, an
// offset and a length a lane) and the card builds the words.
//
// What it computes: out[g, r, b] holds bytes [4 r, 4 r + 4) of lane b's
// payload in group g, the first in the high byte, zero past the payload;
// every word of the output is written, zeros included (the caller
// allocates it uninitialised). A lane longer than 4 * pw bytes, or whose
// range does not lie inside the data, gets an all-zero column, as an
// empty lane: the decoder then flags the lane (its length in the meta is
// not zero), and the host codec decodes it.
//
// What bounds it: bytes. The payload bytes are read once and every word
// written once: at the checkpoint's 512 x 64 KiB group (payloads about
// 55 KB, pw about 16.4k rows) about 28 MB in and 34 MB out, 0.019 ms at
// 3.35 TB/s.
//
// The design:
// - a CTA takes a tile of kLanes = 32 adjacent lanes by kPackRows rows of
//   one group. A warp reads one lane's rows at a time, a thread a word:
//   32 consecutive words of the lane's bytes, one 128-byte run. A payload
//   starts at any byte, so a thread loads the aligned word that holds its
//   first byte and, off a 4-byte boundary, the next one too, joined by a
//   funnel shift (the second load hits the line its neighbour loaded),
//   then swaps the bytes into big-endian order (pack_word);
// - the words are staged lane-major in shared memory, kPackRows + 1
//   words a lane (the pad word: a warp's 32 rows of one lane and a
//   warp's 32 lanes of one row each hit 32 banks), and after one CTA
//   barrier each warp writes whole rows of the tile, 32 lanes of a row as
//   one 128-byte store;
// - rows past a lane's payload load nothing and store zeros.
//
// What a host compiler sees: pack_len and pack_word, plain C++ on the
// byte swap of sqz4_warp.cuh (tests/test_torch_csrc_host.py computes
// every word of a packing with them); the kernel and its launcher are
// device code. The aligned loads never leave the data's allocation: they
// read only words that hold a byte of the data, and the launcher aligns
// the data's base address down to a word.

#include <stdint.h>

#include "sqz4_warp.cuh"
#include "sqz_tile.cuh"

namespace sqz4 {

// Word `row` of one lane's column: bytes [4 row, 4 row + 4) of the lane's
// payload, the `len` bytes at byte `off` of the word array `data4`, in
// big-endian order and zero past the payload.
SQZ_DEVICE uint32_t pack_word(const uint32_t* data4, long long off,
                              long long len, long long row) {
    const long long j = 4 * row;   // the word's first payload byte
    if (j >= len) return 0u;
    const long long a = off + j;
    const int s = static_cast<int>(a & 3);
    const uint32_t lo = data4[a >> 2];
    const uint32_t hi = s != 0 && j + 4 - s < len ? data4[(a >> 2) + 1] : 0u;
    const uint32_t v = bswap32(static_cast<uint32_t>(
        ((static_cast<uint64_t>(hi) << 32) | lo) >> (8 * s)));
    const long long n = len - j;   // payload bytes in the word
    return n >= 4 ? v : v & ~(0xffffffffu >> (8 * n));
}

// The bytes lane (off, len) packs into pw rows: len, or 0 (an all-zero
// column) for a lane longer than 4 * pw bytes or outside the data's
// nbytes.
SQZ_DEVICE long long pack_len(long long off, long long len,
                              long long nbytes, int pw) {
    return len > 4LL * pw || off < 0 || len > nbytes - off ? 0 : len;
}

}  // namespace sqz4

#ifdef __CUDACC__

namespace sqz4 {

constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kPackRows = 64;                  // rows of a tile
constexpr int kPackPitch = kPackRows + 1;      // staged words a lane

__global__ void __launch_bounds__(kPackThreads)
sqz4_pack_kernel(const uint32_t* __restrict__ data4, long long base,
                 long long nbytes, const long long* __restrict__ offsets,
                 const long long* __restrict__ lengths, int lanes, int pw,
                 uint32_t* __restrict__ out) {
    using sqz_tile::kLanes;
    __shared__ uint32_t tile[kLanes * kPackPitch];
    const int g = blockIdx.z, lane0 = blockIdx.y * kLanes;
    const int r0 = blockIdx.x * kPackRows;
    const int nl = min(kLanes, lanes - lane0);
    const int l = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int c = warp; c < kLanes; c += kPackWarps) {
        long long off = 0, len = 0;
        if (c < nl) {
            const long long i = static_cast<long long>(g) * lanes + lane0 + c;
            off = offsets[i];
            len = pack_len(off, lengths[i], nbytes, pw);
        }
#pragma unroll
        for (int r = l; r < kPackRows; r += 32)
            tile[c * kPackPitch + r] = pack_word(data4, base + off, len,
                                                 r0 + r);
    }
    __syncthreads();
    const int nr = min(kPackRows, pw - r0);
    uint32_t* dst = out + (static_cast<long long>(g) * pw + r0) * lanes
                    + lane0;
    if (l < nl)
        for (int r = warp; r < nr; r += kPackWarps)
            dst[static_cast<long long>(r) * lanes + l] = tile[l * kPackPitch
                                                              + r];
}

}  // namespace sqz4

// data: the payload bytes (nbytes of them, any alignment); offsets,
// lengths: [G, lanes] i64, lane b of group g's bytes at data + offset;
// out: [G, pw, lanes] u32, every word written. Launches ceil(pw / 64) x
// ceil(lanes / 32) x G CTAs on `stream`; returns the cudaError_t of the
// launch (cudaErrorInvalidValue past 65535 groups).
extern "C" int sqz4_pack_launch(const void* data, long long nbytes,
                                const void* offsets, const void* lengths,
                                int G, int lanes, int pw, void* out,
                                void* stream) {
    if (G <= 0 || lanes <= 0 || pw <= 0) return 0;
    if (G > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const auto p = reinterpret_cast<uintptr_t>(data);
    const dim3 grid((pw + sqz4::kPackRows - 1) / sqz4::kPackRows,
                    (lanes + 31) / 32, G);
    sqz4::sqz4_pack_kernel<<<grid, sqz4::kPackThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint32_t*>(p & ~uintptr_t{3}),
        static_cast<long long>(p & 3), nbytes,
        static_cast<const long long*>(offsets),
        static_cast<const long long*>(lengths), lanes, pw,
        static_cast<uint32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
