// sqz4 op-stream block encoder for Hopper (sm_90a).
//
// Replaces the TPU kernel sqz_tpu/ops/sqz4_pallas.py:_encode_full_kernel
// (launcher _encode_full_pallas_call) in both its modes: cold, and seeded
// (seeded=True, launcher _encode_full_pallas_seeded), where every block
// but one starts its models from a warm seed (sqz4_chain.cuh kSeed*: the
// rescaled final state of block 0, FORMAT.md §3.1) instead of fresh
// counts. A seeded launch takes the seed as one column of kSeedWords
// int32 words, shared by its blocks, and the index of the one block that
// stays cold (block 0 of a warm container's device pass; -1 for none);
// a cold launch passes a null seed. Only the models' start differs: the
// producer reads the seed once a block, and the rest of the chain is the
// cold one's.
//
// Input: the packed (model, symbol) micro-op streams m_ops / s_ops,
// uint32 [G, T/4, B], four big-endian u8 ops per word (op codes: 0 flag,
// 1 size, 2 byte, 3 bits (symbol clamped to 31), 4..35 distance bit
// (symbol read as s != 0), 254 flush, anything else a no-op pad). Output:
// payload words uint32 [G, cap_words, B] (big-endian bytes; bytes past
// cap_words * 4 are dropped) and lens int32 [G, 8, B] (row 0 = payload
// byte length, which may exceed the capacity).
//
// What bounds it: each block is one serial dependence chain of coder
// steps (a launch holds one chain per block, 512 for 32 MiB of 64 KiB
// blocks, on 132 SMs), so the time is the symbols of the longest block
// times the latency of one step: latency, not bandwidth or arithmetic.
// The one-thread design before this one spent ~1,040 SM cycles a symbol
// on pseudo-text: a software u64 divide, Fenwick-tree model lookups and
// updates in shared memory, strided global loads of the op words and a
// byte sink all sat on that chain.
//
// What the design does about it: the token encoder's two warps
// (sqz4_pair.cuh). The statistics of an op depend only on the ops before
// it, not on the coder's registers, so they leave the chain:
//   - A producer warp (OpProducer) takes 32 ops at a time, one a lane,
//     and computes their statistics with the window step
//     (sqz4_window.cuh): each op's model's statistics at the window's
//     start, from the models in the lanes' registers (LaneModels), plus
//     the counts among the window's earlier ops of the same model, from
//     one pass of 31 shuffles of a packed (model, symbol) key; then the
//     window's counts update the models at once. A ballot and a
//     popcount drop the pads and place the coded ops in the buffer; a
//     flush ends a buffer (the flushes follow its ops), so the coder's
//     loop has no branch. The lanes then compute the buffer's
//     reciprocals side by side.
//   - A coder warp runs only ChainCoder::code per op (sqz4_chain.cuh): a
//     high multiply and a remainder test for the divide (no `/` on the
//     chain), multiplies, adds, xor, a leading-zero count, shifts.
//   - The op words come into shared memory a chunk at a time (Stager, a
//     word a lane at the column's stride), a chunk before they are used.
//   - Four blocks a CTA, one coder chain on each of an SM's schedulers.
// The host tests build this file with g++, where a warp is one lane
// (sqz4_warp.cuh): the windows are then one op long; the 32-lane window
// arithmetic runs only on the card.

#include "sqz4_pair.cuh"
#include "sqz4_window.cuh"

namespace sqz4 {

struct OpSmem {
    uint32_t m[2 * kStage];
    uint32_t s[2 * kStage];
    int hist[kHist];
    PairBufs pair;
};

// Turns a block's op stream into coder ops and their model statistics,
// kLanes ops at a time.
struct OpProducer {
    LaneModels md;
    Stager<uint32_t> m, s;
    int* hist;
    int n_ops;   // ops in the stream
    int o;       // the next op
    bool done;

    SQZ_DEVICE void init(OpSmem* sm, const uint32_t* m_ops,
                         const uint32_t* s_ops, int op_words, int lanes,
                         const int32_t* seed) {
        md.init(seed);
        m.init(m_ops, op_words, lanes, sm->m);
        s.init(s_ops, op_words, lanes, sm->s);
        hist = sm->hist;
        for (int i = lane_id(); i < kHist; i += kLanes) hist[i] = 0;
        warp_sync();
        n_ops = 4 * op_words;
        o = 0;
        done = n_ops == 0;
    }

    // op p of a staged stream (the word holding it staged)
    SQZ_DEVICE static int op(const Stager<uint32_t>& st, int p) {
        return (st.at(p >> 2) >> (24 - 8 * (p & 3))) & 0xFF;
    }

    // Statistics of the coded ops of the lanes in mask `in` (model mo,
    // symbol so a lane), into entries n.. of r in lane order; then the
    // models take their counts (window_step, sqz4_window.cuh).
    SQZ_DEVICE void code_ops(Ring& r, int n, int mo, int so, unsigned in) {
        window_step(md, hist, mo, so, in,
                    [&](uint32_t total, uint32_t start, uint32_t size) {
                        entry(r, n + popc(in & below(lane_id())), total,
                              start, size);
                    });
    }

    // The window of ops o .. o + kLanes - 1 into buffer r from entry *n
    // on, after *flushes flushes (both counts kept in registers until the
    // buffer is full); returns true when it ends the buffer.
    SQZ_DEVICE bool window(Ring& r, int* n, int* flushes) {
        const int p = o + lane_id();
        m.ensure((o + kLanes - 1) >> 2);
        s.ensure((o + kLanes - 1) >> 2);
        const int mo = p < n_ops ? op(m, p) : kOpPad;
        const int so = op(s, p);
        const bool coded = mo < kOpDist + 32;
        const Take w = take_window(ballot(coded), ballot(mo == kOpFlush),
                                   flushes);
        const unsigned in = ballot(coded && lane_id() < w.seg);
        if (in) code_ops(r, *n, mo, so, in);
        *n += popc(in);
        o += w.adv;
        done = o >= n_ops;
        return w.end;
    }

    SQZ_DEVICE bool fill(Ring& r) { return fill_windows(*this, r); }
};

// Encode one block's op stream (op_words words of m_ops and s_ops, rows
// `lanes` elements apart), its models started from `seed` (kSeed* layout)
// or, where it is null, cold. words / len_out are offset to the lane;
// rows of words are `lanes` elements apart and must be zero-filled by the
// caller. role and bar as in sqz4_pair.cuh (kRoleBoth: one warp, or the
// host).
SQZ_DEVICE void encode_lane(const uint32_t* m_ops, const uint32_t* s_ops,
                            int op_words, int lanes, const int32_t* seed,
                            uint32_t* words, int cap_words, int32_t* len_out,
                            OpSmem* sm, int role, int bar) {
    if (role == kRoleConsumer) {
        code_buffers(&sm->pair, bar);
        return;
    }
    OpProducer prod;
    prod.init(sm, m_ops, s_ops, op_words, lanes, seed);
    produce_buffers(prod, &sm->pair, role, bar, words, lanes, cap_words,
                    len_out);
}

}  // namespace sqz4

#ifdef __CUDACC__

// One block a pair of warps (or one warp at 32 threads a CTA), up to
// four blocks a CTA: sqz4_pair.cuh. kSeeded: the seeded mode; the cold
// instantiation starts every block's models cold at compile time, so it
// holds the cold code alone.
template <bool kSeeded>
__global__ void __launch_bounds__(64 * sqz4::kMaxBlocks)
sqz4_encode_kernel(const uint32_t* __restrict__ m_ops,
                   const uint32_t* __restrict__ s_ops, int n_lanes,
                   int op_words, int lanes,
                   const int32_t* __restrict__ seed, int fresh_block,
                   uint32_t* __restrict__ words, int cap_words,
                   int32_t* __restrict__ lens) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const sqz4::PairSlot at = sqz4::pair_slot();
    if (at.n >= n_lanes) return;
    const long long g = at.n / lanes, b = at.n % lanes;
    sqz4::encode_lane(m_ops + g * op_words * lanes + b,
                      s_ops + g * op_words * lanes + b, op_words, lanes,
                      kSeeded && at.n != fresh_block ? seed : nullptr,
                      words + g * cap_words * lanes + b, cap_words,
                      lens + g * 8 * lanes + b,
                      reinterpret_cast<sqz4::OpSmem*>(smem_raw) + at.j,
                      at.role, 4 * at.j);
}

// m_ops, s_ops: [groups, op_words, lanes] u32; words: [groups, cap_words,
// lanes] u32, zero-filled; lens: [groups, 8, lanes] i32, zero-filled.
// seed: null (cold) or kSeedWords i32 (every block but block fresh_block,
// counted g * lanes + b, starts warm from it). threads: 32, 64, 128, 192
// or 256 a CTA. Launches on `stream`; returns the cudaError_t of the
// launch.
extern "C" int sqz4_encode_launch(const void* m_ops, const void* s_ops,
                                  int groups, int op_words, int lanes,
                                  void* words, int cap_words, void* lens,
                                  const void* seed, int fresh_block,
                                  int threads, void* stream) {
    const int n_lanes = groups * lanes;
    return sqz4::pair_launch(
        seed ? sqz4_encode_kernel<true> : sqz4_encode_kernel<false>,
        sizeof(sqz4::OpSmem), n_lanes, threads, stream,
        static_cast<const uint32_t*>(m_ops),
        static_cast<const uint32_t*>(s_ops), n_lanes, op_words, lanes,
        static_cast<const int32_t*>(seed), fresh_block,
        static_cast<uint32_t*>(words), cap_words,
        static_cast<int32_t*>(lens));
}

#endif  // __CUDACC__
