// sqz4 token-input block encoder for Hopper (sm_90a).
//
// Replaces the TPU kernel sqz_tpu/ops/sqz4_pallas.py:_encode_tok_kernel
// (launcher _encode_tok_pallas_call), in both of its modes: the literal
// stream compacted by the planner, and lit_skip (below).
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
// The op sequence is the Pallas kernel's: its (token, phase) machine
// expands each token into op pairs, one pair per step for at most t_max
// steps: a literal codes (flag 1, byte), a match (flag 0, size), (bits,
// distance bit 0), then two distance bits a pair, the EOS token (flag 0,
// size 255) and four pairs of flushes. That is the op sequence native
// sqz4_fast_plan emits for the same parse, and the pads of the pairing
// code nothing, so the bytes equal the op-stream encoder's (the
// reference's own contract, tests/test_sqz4_pallas.py:278). Here a token
// expands at once, with the pair budget cut exactly where the machine's
// steps would stop (TokProducer::match, fill).
//
// What bounds it: each block is one serial chain of coder steps (a launch
// holds one chain per block, 512 for a 32 MiB group, on 132 SMs), so the
// time is the symbols of the longest block times the latency of one
// step: latency, not bandwidth or arithmetic. The one-thread design
// before this one spent ~1,100 SM cycles a symbol: a software u64
// divide, the model lookups and updates, global loads of tokens and
// literals, and the byte emission all sat on that chain.
//
// What the design does about it: an encoder's statistics depend only on
// its op sequence, not on the coder's registers, so they leave the chain,
// and so do its output bytes.
//   - A producer warp (TokProducer) expands a token, or 32 literals of a
//     run, at a time into coder ops and their model statistics (start,
//     size, total) in a buffer of kRingOps ops in shared memory. Its
//     models live in its lanes' registers (sqz4_chain.cuh LaneModels): a
//     match's distance bits, each with its own model, are coded by as
//     many lanes at once; a literal chunk's byte statistics are the
//     model's before the chunk plus the chunk's earlier bytes below and
//     equal to each (32 shuffles), and its counts update the model at
//     once. The lanes then compute the buffer's reciprocals recip64(total)
//     side by side.
//   - A coder warp (ChainCoder) runs only the code_stats arithmetic per
//     op: a high multiply and a remainder test for the divide
//     (sqz4_div.cuh; no `/` anywhere in this kernel), multiplies, adds,
//     xor, a leading-zero count, shifts, and a record of the settled
//     bytes (pre, cnt) in the buffer. It reads each op's entry while coding
//     the one before, so no load waits on the chain.
//   - The producer warp turns a buffer's records into payload words (a
//     ByteEmitter: a warp scan of the counts places 32 records' bytes at
//     once) when the coder hands the buffer back, before refilling it.
//   - Tokens and literal bytes reach the producer through shared memory,
//     a chunk loaded into the lanes' registers (coalesced) a chunk before
//     it is needed (Stager).
//   - The pair of warps, the hand-over of two buffers through named
//     barriers, the byte emission and the launch geometry are the
//     encoders' shared skeleton (sqz4_pair.cuh). 256 threads a CTA hold
//     four blocks, one coder chain on each of an SM's schedulers, and the
//     128 CTAs of a 512-block launch take one SM each; 64 threads, one
//     block (two coder warps may then share a scheduler); 32, one warp
//     that produces a buffer and then codes it. The wrapper launches
//     256, the fastest (PERF.md has the times of each).
// What bounds it now: the coder warp's chain, ~200 SM cycles an op on
// pseudo-text (64-bit values as 32-bit pairs), and the issue slots it
// shares with the CTA's other warps: half the blocks at one pair a CTA ran
// 10% faster, while leaving out the byte emission saved 1%
// (scripts/chain_variants.py, PERF.md).
// The reference's token kernel has no seeded mode: warm blocks take the
// op-stream encoder's (sqz4_encode.cu), whose producer starts its models
// from the seed (LaneModels::init(seed)), as this one's would.
//
// lit_skip (the resident paths, ops/resident.py and ops/lzparse.py): the
// literal row is the raw block, so a match token (not EOS) also moves
// the literal cursor past the `len` bytes it covers. The Pallas machine
// drains those bytes at 32 a pair from the pair that fetches the token,
// and a lane whose coding pairs end first waits (PAD pairs, which code
// nothing) until the drain is done: the coded ops are the cold mode's,
// and a match takes max(coding pairs, ceil(len / 32)) pairs of the
// budget. So only TokProducer::match changes; the mode is a template
// argument, and the cold instantiation compiles as before.

#include "sqz4_pair.cuh"

namespace sqz4 {

constexpr int kTokOps = 64;     // the most ops one token pass adds
constexpr int kLitPer = 32 / kLanes;   // literals of a chunk a lane holds

struct TokSmem {
    uint32_t tok[2 * kStage];
    uint8_t lit_bytes[2 * kStage];
    int hist[256];
    PairBufs pair;
};

// Expands a block's tokens into coder ops and their model statistics, a
// token (or 32 literals) at a time, the warp's lanes side by side.
// kLitSkip: the literal row is the raw block (see the top of the file).
template <bool kLitSkip>
struct TokProducer {
    LaneModels md;
    Stager<uint32_t> toks;
    Stager<uint8_t> lits;
    int* hist;
    int t_max, t;   // the pair budget, and the pairs used
    int run;        // literals left of the current literal-run token
    int tidx, lidx;
    bool done;

    SQZ_DEVICE void init(TokSmem* s, const uint32_t* tk, int tok_rows,
                         const uint8_t* lt, int lit_bytes, int steps) {
        md.init();
        toks.init(tk, tok_rows, 1, s->tok);
        lits.init(lt, lit_bytes, 1, s->lit_bytes);
        hist = s->hist;
        for (int i = lane_id(); i < 256; i += kLanes) hist[i] = 0;
        warp_sync();
        t_max = steps, t = 0;
        run = tidx = lidx = 0;
        done = false;
    }

    // a literal flag (symbol s), in order
    SQZ_DEVICE void flag(Ring& r, int i, int s) {
        const int a = md.lit0, b = md.lit1;
        entry(r, i, a + b, s ? a : 0, s ? b : a);
        md.lit0 += !s;
        md.lit1 += s;
    }

    template <int N>
    SQZ_DEVICE void model(LaneModel<N>& m, Ring& r, int i, int s) {
        int start, size;
        m.stats(s, &start, &size);
        entry(r, i, m.total, start, size);
        m.bump(s);
    }

    // A match or EOS token with `budget` pairs left: its ops from entry n
    // on; returns their count. Pairs: (flag 0, size), (bits, distance bit
    // 0), then distance bits two a pair; EOS (flag 0, size 255) and four
    // pairs of flushes, after which the lane is done. kLitSkip: a match
    // holds the lane for ceil(len / 32) pairs at least, and the lane
    // stops inside them if the budget ends there.
    SQZ_DEVICE int match(Ring& r, int n, uint32_t tok, int budget) {
        const int len = tok & 0xFF, nb = (tok >> 9) & 0x1F;
        const int dist = (tok >> 16) & 0x7FFF;
        flag(r, n, 0);
        model(md.size, r, n + 1, len);
        if (len == 255) {
            const int fl = budget - 1 < 4 ? budget - 1 : 4;
            r.flushes = 2 * fl;   // after every op of this last buffer
            t += 1 + fl;
            done = true;
            return 2;
        }
        if (budget < 2) {
            t += 1;
            done = true;
            return 2;
        }
        model(md.bits, r, n + 2, nb < 31 ? nb : 31);
        // distance bits 0..nb-2 (the top one is implicit): bit k rides
        // pair 1 + (k + 1) / 2, and each has its own model, so every lane
        // codes the bits of its own models at once
        const int nd = nb > 1 ? nb - 1 : 0, coding = 2 + nd / 2;
        int pairs = coding;
        if (kLitSkip) {
            const int drain = (len + 31) >> 5;
            pairs = drain > coding ? drain : coding;
            lidx += len;   // a jump of at most 254: the literal chunk
                           // window of Stager::ensure still holds it
        }
        const int nok = nd < 2 * budget - 3 ? nd : 2 * budget - 3;
        constexpr int kPer = LaneBinary<32>::kPer;
        SQZ_UNROLL()
        for (int q = 0; q < kPer; ++q) {
            const int k = lane_id() * kPer + q;
            const int a = md.dist.f0[q], b = md.dist.f1[q];
            const int s = (dist >> k) & 1;
            if (k < nok) {
                entry(r, n + 3 + k, a + b, s ? a : 0, s ? b : a);
                md.dist.f0[q] += !s;
                md.dist.f1[q] += s;
            }
        }
        t += pairs < budget ? pairs : budget;
        done = pairs > budget;
        return 3 + nok;
    }

    // The next k (1..32) literals of the current run from entry n on, a
    // flag and a byte each. A literal's byte statistics are the model's
    // before the chunk plus the chunk's earlier literals below it (start)
    // and equal to it (size); then the chunk's counts update the model.
    SQZ_DEVICE void literals(Ring& r, int n, int k) {
        lits.ensure(lidx + k - 1);
        int c[kLitPer], less[kLitPer], eq[kLitPer];
        SQZ_UNROLL()
        for (int q = 0; q < kLitPer; ++q) {
            const int i = lane_id() * kLitPer + q;
            c[q] = i < k ? lits.at(lidx + i) : 0;
            less[q] = eq[q] = 0;
        }
        for (int m = 0; m < k; ++m) {
            const int cm = shfl(c[m % kLitPer], m / kLitPer);
            SQZ_UNROLL()
            for (int q = 0; q < kLitPer; ++q) {
                const int i = lane_id() * kLitPer + q;
                less[q] += m < i && cm < c[q];
                eq[q] += m < i && cm == c[q];
            }
        }
        const int a = md.lit0, b = md.lit1, tot = md.byte.total;
        SQZ_UNROLL()
        for (int q = 0; q < kLitPer; ++q) {
            const int i = lane_id() * kLitPer + q;
            int start, size;
            md.byte.stats_any(c[q], &start, &size);
            if (i < k) {
                entry(r, n + 2 * i, a + b + i, a, b + i);
                entry(r, n + 2 * i + 1, tot + i, start + less[q],
                      size + eq[q]);
                smem_add(&hist[c[q]], 1);
            }
        }
        warp_sync();
        constexpr int kPer = LaneModel<256>::kPer;
        int inc[kPer];
        SQZ_UNROLL()
        for (int j = 0; j < kPer; ++j) inc[j] = hist[lane_id() * kPer + j];
        warp_sync();
        SQZ_UNROLL()
        for (int j = 0; j < kPer; ++j) hist[lane_id() * kPer + j] = 0;
        warp_sync();
        md.byte.add(inc, k);
        md.lit1 += k;
        lidx += k;
        run -= k;
        t += k;
    }

    // Fill buffer r (whole tokens or literal chunks, at most kRingOps
    // ops) and its reciprocals; returns true when this is the block's last
    // buffer.
    SQZ_DEVICE bool fill(Ring& r) {
        int n = 0;
        r.flushes = 0;
        while (!done && n <= kRingOps - kTokOps) {
            const int budget = t_max - t;
            if (budget <= 0) {
                done = true;
            } else if (run > 0) {
                const int k = run < 32 ? (run < budget ? run : budget)
                                       : (32 < budget ? 32 : budget);
                literals(r, n, k);
                n += 2 * k;
            } else {
                const uint32_t tok = toks.get(tidx++);
                if (tok == 0) done = true;   // a pad: nothing more
                else if ((tok >> 8) & 1) n += match(r, n, tok, budget);
                else run = tok & 0xFF;
            }
        }
        warp_sync();
        recips(r, n);
        r.n = n;
        r.last = done;
        warp_sync();
        return done;
    }
};

// Encode one block from its token row (tok_rows tokens) and literal row
// (lit_bytes bytes); reads past either row see zeros, as the Pallas
// kernel's windows do. words / len_out are offset to the lane; rows of
// words are `lanes` elements apart and must be zero-filled by the caller.
// role: kRoleBoth (one warp, or the host: produce a buffer, then code
// it), or the producer or the coder warp of a pair that hands buffers
// over through named barriers bar .. bar + 3 (sqz4_pair.cuh).
template <bool kLitSkip>
SQZ_DEVICE void encode_tok_lane(const uint32_t* toks, int tok_rows,
                                const uint8_t* lits, int lit_bytes,
                                int t_max, int lanes, uint32_t* words,
                                int cap_words, int32_t* len_out,
                                TokSmem* sm, int role, int bar) {
    if (role == kRoleConsumer) {
        code_buffers(&sm->pair, bar);
        return;
    }
    TokProducer<kLitSkip> prod;
    prod.init(sm, toks, tok_rows, lits, lit_bytes, t_max);
    produce_buffers(prod, &sm->pair, role, bar, words, lanes, cap_words,
                    len_out);
}

}  // namespace sqz4

#ifdef __CUDACC__

// One block a pair of warps (or one warp at 32 threads a CTA), up to
// four blocks a CTA: sqz4_pair.cuh.
template <bool kLitSkip>
__global__ void __launch_bounds__(64 * sqz4::kMaxBlocks)
sqz4_encode_tok_kernel(const uint32_t* __restrict__ toks, int tok_rows,
                       const uint8_t* __restrict__ lits, int lit_bytes,
                       int n_lanes, int lanes, int t_max,
                       uint32_t* __restrict__ words, int cap_words,
                       int32_t* __restrict__ lens) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const sqz4::PairSlot at = sqz4::pair_slot();
    if (at.n >= n_lanes) return;
    const long long n = at.n, g = n / lanes, b = n % lanes;
    sqz4::encode_tok_lane<kLitSkip>(
        toks + n * tok_rows, tok_rows, lits + n * lit_bytes, lit_bytes,
        t_max, lanes, words + g * cap_words * lanes + b, cap_words,
        lens + g * 8 * lanes + b,
        reinterpret_cast<sqz4::TokSmem*>(smem_raw) + at.j, at.role,
        4 * at.j);
}

// toks: [groups, lanes, tok_rows] u32; lits: [groups, lanes, lit_bytes]
// u8; words: [groups, cap_words, lanes] u32, zero-filled; lens: [groups,
// 8, lanes] i32, zero-filled. threads: 32, 64, 128, 192 or 256 a CTA (see
// the kernel). lit_skip nonzero: lits holds the raw blocks and match
// tokens skip the bytes they cover (the resident paths). Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int sqz4_encode_tok_launch(const void* toks, int tok_rows,
                                      const void* lits, int lit_bytes,
                                      int groups, int lanes, int t_max,
                                      void* words, int cap_words, void* lens,
                                      int threads, int lit_skip,
                                      void* stream) {
    const int n_lanes = groups * lanes;
    return sqz4::pair_launch(
        lit_skip ? sqz4_encode_tok_kernel<true>
                 : sqz4_encode_tok_kernel<false>,
        sizeof(sqz4::TokSmem), n_lanes, threads, stream,
        static_cast<const uint32_t*>(toks), tok_rows,
        static_cast<const uint8_t*>(lits), lit_bytes, n_lanes, lanes, t_max,
        static_cast<uint32_t*>(words), cap_words,
        static_cast<int32_t*>(lens));
}

#endif  // __CUDACC__
