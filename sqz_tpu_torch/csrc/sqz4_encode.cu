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
// are staged in a register word and stored once per four bytes. The coder
// step itself (sqz4_coder.cuh Encoder::code) is shared with the token
// encoder (sqz4_encode_tok.cu). Keeping more chains in flight per SM (a
// warp per block, more blocks per call) is later work.

#include "sqz4_coder.cuh"

namespace sqz4 {

// Encode one block's op stream. Pointers are offset to the lane; rows of
// m_ops / s_ops / words are `lanes` elements apart. The output column must
// be zero-filled by the caller.
SQZ_DEVICE void encode_lane(const uint32_t* m_ops, const uint32_t* s_ops,
                            int op_words, int lanes, uint32_t* words,
                            int cap_words, int32_t* len_out, int* tab,
                            int stride) {
    Encoder enc = make_encoder(words, lanes, cap_words, tab, stride);
    uint32_t mw = 0, sw = 0;
    const int n_ops = op_words * 4;
    for (int t = 0; t < n_ops; ++t) {
        if ((t & 3) == 0) {
            mw = m_ops[static_cast<long long>(t >> 2) * lanes];
            sw = s_ops[static_cast<long long>(t >> 2) * lanes];
        }
        const int sh = 24 - 8 * (t & 3);
        enc.code((mw >> sh) & 0xFF, (sw >> sh) & 0xFF);
    }
    *len_out = enc.finish();
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
