// sqz4 block encoder for Hopper (sm_90a).
//
// Replaces the TPU kernel sqz_tpu/ops/sqz4_pallas.py:_encode_full_kernel
// (launcher _encode_full_pallas_call), cold (unseeded) mode.
//
// Input: the packed (model, symbol) micro-op streams m_ops / s_ops,
// uint32 [G, T/4, B], four big-endian u8 ops per word (op codes: 0 flag,
// 1 size, 2 byte, 3 bits, 4..35 distance bit, 254 flush, anything else a
// no-op pad). Output: payload words uint32 [G, cap_words, B] (big-endian
// bytes; bytes past cap_words * 4 are dropped) and lens int32 [G, 8, B]
// (row 0 = payload byte length, which may exceed the capacity).
//
// What bounds it: each block is one serial dependence chain (model
// lookup -> 64-bit divide -> multiply -> renormalize, op after op), and a
// call carries as many chains as there are blocks: 512 for 32 MiB of
// 64 KiB blocks, against the card's 132 SMs. Throughput is the chain's
// latency, not bandwidth or arithmetic.
//
// What the design does about it: one thread per block and one per CTA,
// so the blocks spread over every SM and no warp serializes the diverging
// paths of several blocks; the coder registers are native u64 (one
// hardware divide per op where the TPU kernel ran a five-digit f32 long
// division on u32 pairs); the 256-symbol models are Fenwick trees in
// shared memory (statistics and update in log2(256) steps); output bytes
// are staged in a register word and stored once per four bytes. Keeping
// more chains in flight per SM (a warp per block, more blocks per call)
// is later work.

#include "sqz4_coder.cuh"

namespace sqz4 {

// Big-endian byte sink into one lane's column of the output words.
struct WordSink {
    uint32_t* out;
    int stride;
    long long cap_words;
    uint32_t acc;
    long long n;

    SQZ_DEVICE void put(uint32_t byte) {
        acc = (acc << 8) | byte;
        if ((n & 3) == 3 && (n >> 2) < cap_words)
            out[(n >> 2) * stride] = acc;
        ++n;
    }

    SQZ_DEVICE void finish() {
        const int r = static_cast<int>(n & 3);
        if (r && (n >> 2) < cap_words)
            out[(n >> 2) * stride] = acc << (8 * (4 - r));
    }
};

// Encode one block's op stream. Pointers are offset to the lane; rows of
// m_ops / s_ops / words are `lanes` elements apart. The output column must
// be zero-filled by the caller.
SQZ_DEVICE void encode_lane(const uint32_t* m_ops, const uint32_t* s_ops,
                            int op_words, int lanes, uint32_t* words,
                            int cap_words, int32_t* len_out, int* tab,
                            int stride) {
    init_tables(tab, stride);
    u64 low = 0, rng = ~0ull;
    WordSink sink{words, lanes, cap_words, 0u, 0};
    uint32_t mw = 0, sw = 0;
    const int n_ops = op_words * 4;
    for (int t = 0; t < n_ops; ++t) {
        if ((t & 3) == 0) {
            mw = m_ops[static_cast<long long>(t >> 2) * lanes];
            sw = s_ops[static_cast<long long>(t >> 2) * lanes];
        }
        const int sh = 24 - 8 * (t & 3);
        const int m = (mw >> sh) & 0xFF;
        int s = (sw >> sh) & 0xFF;
        if (m == kOpFlush) {   // exactly one emission of the top byte
            sink.put(static_cast<uint32_t>(low >> 56));
            low <<= 8;
            continue;
        }
        if (m >= kOpDist + 32) continue;   // pad

        // model statistics, read strictly before the adaptive update
        int start, size, total;
        if (m == kOpByte || m == kOpSize) {
            Model256 md = model256(tab, stride, m == kOpByte);
            start = md.start(s);
            size = md.size(s);
            total = md.total();
            md.bump(s);
        } else if (m == kOpBits) {
            s = s < 31 ? s : 31;
            int* c = tab + kBits * stride;
            csum_stats(c, stride, 32, s, &start, &size, &total);
            csum_bump(c, stride, s, 32);
        } else {
            s = s != 0;
            int* f0 = tab + (m == kOpFlag ? kLit : kDist0 + m - kOpDist) * stride;
            int* f1 = m == kOpFlag ? f0 + stride
                                   : tab + (kDist1 + m - kOpDist) * stride;
            total = *f0 + *f1;
            start = s ? *f0 : 0;
            size = s ? *f1 : *f0;
            *(s ? f1 : f0) += 1;
        }

        const u64 q = rng / static_cast<u64>(total);
        low += static_cast<u64>(start) * q;
        rng = static_cast<u64>(size) * q;
        const u64 pre = low;
        int cnt = lead_zero_bytes(low ^ (low + rng));
        low = shl(low, 8 * cnt);
        rng = shl(rng, 8 * cnt);
        if (rng < static_cast<u64>(total) + 1) {
            // underflow escape: two more emissions, re-inflate the range
            low = shl(pre, 8 * cnt + 16);
            rng = ~low;
            cnt += 2;
        }
        for (int k = 0; k < cnt; ++k)
            sink.put(k < 8 ? static_cast<uint32_t>(pre >> (56 - 8 * k)) & 0xFF
                           : 0u);
    }
    sink.finish();
    *len_out = static_cast<int32_t>(sink.n);
}

}  // namespace sqz4

#ifdef __CUDACC__

__global__ void sqz4_encode_kernel(const uint32_t* __restrict__ m_ops,
                                   const uint32_t* __restrict__ s_ops,
                                   int n_lanes, int op_words, int lanes,
                                   uint32_t* __restrict__ words,
                                   int cap_words, int32_t* __restrict__ lens) {
    extern __shared__ int smem[];
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= n_lanes) return;
    const long long g = n / lanes, b = n % lanes;
    sqz4::encode_lane(m_ops + g * op_words * lanes + b,
                      s_ops + g * op_words * lanes + b, op_words, lanes,
                      words + g * cap_words * lanes + b, cap_words,
                      lens + g * 8 * lanes + b, smem + threadIdx.x,
                      blockDim.x);
}

// m_ops, s_ops: [groups, op_words, lanes] u32; words: [groups, cap_words,
// lanes] u32, zero-filled; lens: [groups, 8, lanes] i32, zero-filled.
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int sqz4_encode_launch(const void* m_ops, const void* s_ops,
                                  int groups, int op_words, int lanes,
                                  void* words, int cap_words, void* lens,
                                  int threads, void* stream) {
    const int n_lanes = groups * lanes;
    const size_t smem = sizeof(int) * sqz4::kTableWords * threads;
    cudaError_t err = cudaFuncSetAttribute(
        sqz4_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int ctas = (n_lanes + threads - 1) / threads;
    sqz4_encode_kernel<<<ctas, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(m_ops),
        static_cast<const uint32_t*>(s_ops), n_lanes, op_words, lanes,
        static_cast<uint32_t*>(words), cap_words,
        static_cast<int32_t*>(lens));
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
