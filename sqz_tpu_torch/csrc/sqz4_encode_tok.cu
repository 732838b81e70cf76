// sqz4 token-input block encoder for Hopper (sm_90a).
//
// Replaces the TPU kernel sqz_tpu/ops/sqz4_pallas.py:_encode_tok_kernel
// (launcher _encode_tok_pallas_call), cold mode without lit_skip.
//
// Input: the native token planner's rows as they come (sqz_native.cpp
// sqz4_tok_plan): toks uint32 [G, B, tok_rows], one row per block, one
// token per parse decision, and lits uint8 [G, B, lit_bytes], the block's
// literal bytes in order. Token layout:
//   bits 0..7   literal-run count (1..255) | match length (2..254) | 255 EOS
//   bit  8      1 = match / EOS, 0 = literal run
//   bits 9..13  match distance bit-length
//   bits 16..30 match distance
//   0           pad: the lane is done
// Output: as the op-stream encoder's (sqz4_encode.cu): payload words
// uint32 [G, cap_words, B] (big-endian bytes) and lens int32 [G, 8, B]
// (row 0 = payload byte length).
//
// Each thread expands its block's tokens into the coder's op pairs with
// the Pallas kernel's (token, phase) machine, one pair per step for at
// most t_max steps: a literal codes (flag 1, byte), a match (flag 0,
// size), (bits, distance bit 0), then two distance bits a pair, the EOS
// token (flag 0, size 255) and four pairs of flushes. That is the op
// sequence native sqz4_fast_plan emits for the same parse, and the pads
// of the pairing code nothing, so the bytes equal the op-stream
// encoder's (the reference's own contract, tests/test_sqz4_pallas.py:278).
// The coding goes through the shared coder step (sqz4_coder.cuh).
//
// What bounds it: as for the op-stream encoder, each block is one serial
// dependence chain of coder steps, and a call carries one chain per block
// (512 for a 32 MiB group of 64 KiB blocks, against 132 SMs): latency, not
// bandwidth or arithmetic. What the design does about it: the same launch
// shape (one thread per block, one block per CTA); the token and literal
// rows are read in order by their own thread, so the TPU kernel's
// transposes, sliding windows and one-hot selects (which serve its lane
// layout) have no counterpart; the ~1.1 B of input per input byte against
// ~4.5 B/B of op streams shrinks the upload, not the chain.

#include "sqz4_coder.cuh"

namespace sqz4 {

constexpr uint32_t kTokDone = 0xFFFFFFFFu;   // lane finished
constexpr int kOpPad = 255;

// Encode one block from its token row (tok_rows tokens) and literal row
// (lit_bytes bytes); reads past either row see zeros, as the Pallas
// kernel's windows do. words / len_out are offset to the lane; rows of
// words are `lanes` elements apart and must be zero-filled by the caller.
SQZ_DEVICE void encode_tok_lane(const uint32_t* toks, int tok_rows,
                                const uint8_t* lits, int lit_bytes,
                                int t_max, int lanes, uint32_t* words,
                                int cap_words, int32_t* len_out, int* tab,
                                int stride) {
    Encoder enc = make_encoder(words, lanes, cap_words, tab, stride);
    uint32_t tok = 0;
    int phase = 0, run = 0, tidx = 0, lidx = 0;
    for (int t = 0; t < t_max; ++t) {
        // fetch the next token once the current one is consumed
        const bool need = tok == 0;
        if (need) {
            const uint32_t f = tidx < tok_rows ? toks[tidx] : 0u;
            tok = f ? f : kTokDone;
            ++tidx;
            phase = 0;
        }
        if (tok == kTokDone) break;   // every later pair would be pads

        const bool isflush = phase >= 16;
        const bool ismatch = !isflush && ((tok >> 8) & 1);
        const bool islit = !isflush && !ismatch;
        const int cnt_len = tok & 0xFF;
        const int nb = (tok >> 9) & 0x1F;
        const int dist = (tok >> 16) & 0x7FFF;
        const bool eos = ismatch && cnt_len == 255;
        if (need && islit) run = cnt_len;
        const int lbyte = lidx < lit_bytes ? lits[lidx] : 0;

        // expand (token, phase) -> the pair (m1, s1), (m2, s2)
        const bool p0 = ismatch && phase == 0;
        const bool p1 = ismatch && phase == 1;
        const bool pk = ismatch && phase >= 2;
        const int k1 = 2 * phase - 3, k2 = 2 * phase - 2;
        int m1 = kOpPad, s1 = 0, m2 = kOpPad, s2 = 0;
        if (islit) {
            m1 = kOpFlag, s1 = 1, m2 = kOpByte, s2 = lbyte;
        } else if (p0) {
            m1 = kOpFlag, m2 = kOpSize, s2 = cnt_len;
        } else if (p1) {
            m1 = kOpBits, s1 = nb;
            if (nb >= 2) m2 = kOpDist, s2 = dist & 1;
        } else if (pk) {
            m1 = kOpDist + k1, s1 = (dist >> k1) & 1;
            if (k2 <= nb - 2) m2 = kOpDist + k2, s2 = (dist >> k2) & 1;
        } else if (isflush) {
            m1 = m2 = kOpFlush;
        }

        // advance the expansion state
        const bool litlast = islit && run == 1;
        if (islit) {
            --run;
            ++lidx;
        }
        const bool adv = (p1 && nb <= 2) || (pk && k2 >= nb - 2);
        int next = phase;
        if (p0) next = eos ? 16 : 1;
        else if ((p1 || pk) && !adv) next = phase + 1;
        else if (isflush) next = phase + 1;
        if (litlast || (adv && !eos)) tok = 0;
        if (isflush && next >= 20) tok = kTokDone;
        phase = next;

        enc.code(m1, s1);
        enc.code(m2, s2);
    }
    *len_out = enc.finish();
}

}  // namespace sqz4

#ifdef __CUDACC__

__global__ void sqz4_encode_tok_kernel(const uint32_t* __restrict__ toks,
                                       int tok_rows,
                                       const uint8_t* __restrict__ lits,
                                       int lit_bytes, int n_lanes, int lanes,
                                       int t_max, uint32_t* __restrict__ words,
                                       int cap_words,
                                       int32_t* __restrict__ lens) {
    extern __shared__ int smem[];
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= n_lanes) return;
    const long long g = n / lanes, b = n % lanes;
    sqz4::encode_tok_lane(toks + static_cast<long long>(n) * tok_rows,
                          tok_rows,
                          lits + static_cast<long long>(n) * lit_bytes,
                          lit_bytes, t_max, lanes,
                          words + g * cap_words * lanes + b, cap_words,
                          lens + g * 8 * lanes + b, smem + threadIdx.x,
                          blockDim.x);
}

// toks: [groups, lanes, tok_rows] u32; lits: [groups, lanes, lit_bytes]
// u8; words: [groups, cap_words, lanes] u32, zero-filled; lens: [groups,
// 8, lanes] i32, zero-filled. lit_skip (the resident paths' raw literal
// stream) is not implemented: a nonzero flag returns
// cudaErrorNotSupported. Launches on `stream`; returns the cudaError_t of
// the launch.
extern "C" int sqz4_encode_tok_launch(const void* toks, int tok_rows,
                                      const void* lits, int lit_bytes,
                                      int groups, int lanes, int t_max,
                                      void* words, int cap_words, void* lens,
                                      int threads, int lit_skip,
                                      void* stream) {
    if (lit_skip) return static_cast<int>(cudaErrorNotSupported);
    const int n_lanes = groups * lanes;
    const size_t smem = sizeof(int) * sqz4::kTableWords * threads;
    cudaError_t err = cudaFuncSetAttribute(
        sqz4_encode_tok_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int ctas = (n_lanes + threads - 1) / threads;
    sqz4_encode_tok_kernel<<<ctas, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(toks), tok_rows,
        static_cast<const uint8_t*>(lits), lit_bytes, n_lanes, lanes, t_max,
        static_cast<uint32_t*>(words), cap_words,
        static_cast<int32_t*>(lens));
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
