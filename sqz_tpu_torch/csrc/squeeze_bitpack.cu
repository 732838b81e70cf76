// squeeze bitstream packer for Hopper (sm_90a).
//
// Replaces the TPU kernel sqz_tpu/ops/sqz4_pallas.py:_bitpack_kernel
// (launcher _bitpack_pallas). The native host planner runs each block's
// adaptive-Huffman encode and records its bitstream writes, one u32 a
// write: the bit count in bits 25 and up (0 = a pad record), the value,
// already bit-reversed, in the low 25 bits. This kernel appends every
// lane's values MSB-first at the lane's running bit offset and writes the
// payload as big-endian u32 words in the column layout of the other
// encoders: records uint32 [G, T, B] -> words uint32 [G, cap_words, B]
// (zero past each payload; words past cap_words are dropped) and lens
// int32 [G, 8, B] (row 0 = ceil(bits / 64) * 8, the reference's flush,
// which pads the final 64-bit shift word with zeros).
//
// The arithmetic is the TPU kernel's, step for step: a 64-bit accumulator
// as two u32 halves, the value shifted left by the u32 64 - bitcnt - nb
// (records from the planner carry at most 24 bits, so that shift lies in
// 8..63), one word spilled whenever 32 bits are full, and both halves
// written at the end.
//
// What bounds it: the records are read once and the payload written once
// (~0.9 B of records per input byte), so the bound is bytes, some
// microseconds per 32 MiB. What rules it here is latency: each lane's bit
// offset depends on every earlier record, so one thread walks one lane's
// column, and a 512-block group gives only 512 such walks.
//
// The design: one thread per lane, 32 lanes a CTA, so a warp's loads of
// one record row and its stores of spilled words touch adjacent columns
// (coalesced); records are read eight rows at a time into registers, so
// the loads are in flight together and the serial chain is integer ALU
// work only. A prefix sum of the bit counts would let every record OR its
// bits into at most two words in parallel; that scan design is later
// work.

#include <stdint.h>

#ifndef SQZ_DEVICE
#define SQZ_DEVICE __device__ __forceinline__
#endif

namespace squeeze {

constexpr uint32_t kValueMask = 0x1FFFFFFu;
constexpr int kBatch = 8;   // record rows loaded ahead

// One lane's packer state: the 64-bit accumulator as u32 halves, the
// bits held, and the next word's row.
struct Packer {
    uint32_t* out;
    long long stride;
    uint32_t cap_words;
    uint32_t ah, al, bitcnt, wpos;

    SQZ_DEVICE void put(uint32_t row, uint32_t word) {
        if (row < cap_words) out[row * stride] = word;
    }

    SQZ_DEVICE void append(uint32_t w) {
        const uint32_t nb = w >> 25;
        const uint32_t val = w & kValueMask;
        if (nb) {
            const uint32_t s = 64u - bitcnt - nb;
            const uint32_t s1 = s & 31u;
            if (s >= 32u) {
                ah |= val << s1;
            } else {
                ah |= (val >> 1) >> (31u - s1);
                al |= val << s1;
            }
        }
        bitcnt += nb;
        if (bitcnt >= 32u) {
            put(wpos, ah);
            ++wpos;
            ah = al;
            al = 0;
            bitcnt -= 32u;
        }
    }

    // Spill both halves; returns the payload byte length.
    SQZ_DEVICE int32_t finish() {
        put(wpos, bitcnt ? ah : 0u);
        put(wpos + 1, al);
        const uint32_t bits = (wpos << 5) + bitcnt;
        return static_cast<int32_t>(((bits + 63u) >> 6) << 3);
    }
};

// Pack one lane. Pointers are offset to the lane; rows of ops and words
// are `lanes` elements apart; the output column must be zero-filled.
SQZ_DEVICE void bitpack_lane(const uint32_t* ops, int rows, int lanes,
                             uint32_t* words, int cap_words,
                             int32_t* len_out) {
    Packer pk{words, lanes, static_cast<uint32_t>(cap_words), 0u, 0u, 0u,
              0u};
    int t = 0;
    for (; t + kBatch <= rows; t += kBatch) {
        uint32_t w[kBatch];
        for (int k = 0; k < kBatch; ++k)
            w[k] = ops[static_cast<long long>(t + k) * lanes];
        for (int k = 0; k < kBatch; ++k) pk.append(w[k]);
    }
    for (; t < rows; ++t) pk.append(ops[static_cast<long long>(t) * lanes]);
    *len_out = pk.finish();
}

}  // namespace squeeze

#ifdef __CUDACC__

__global__ void squeeze_bitpack_kernel(const uint32_t* __restrict__ ops,
                                       int n_lanes, int rows, int lanes,
                                       uint32_t* __restrict__ words,
                                       int cap_words,
                                       int32_t* __restrict__ lens) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= n_lanes) return;
    const long long g = n / lanes, b = n % lanes;
    squeeze::bitpack_lane(ops + g * rows * lanes + b, rows, lanes,
                          words + g * cap_words * lanes + b, cap_words,
                          lens + g * 8 * lanes + b);
}

// ops: [groups, rows, lanes] u32; words: [groups, cap_words, lanes] u32,
// zero-filled; lens: [groups, 8, lanes] i32, zero-filled. Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int squeeze_bitpack_launch(const void* ops, int groups, int rows,
                                      int lanes, void* words, int cap_words,
                                      void* lens, int threads, void* stream) {
    const int n_lanes = groups * lanes;
    const int ctas = (n_lanes + threads - 1) / threads;
    squeeze_bitpack_kernel<<<ctas, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(ops), n_lanes, rows, lanes,
        static_cast<uint32_t*>(words), cap_words,
        static_cast<int32_t*>(lens));
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
