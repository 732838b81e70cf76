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
//     size, total) in a buffer of kTokRingOps ops in shared memory. Its
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
//   - The hand-over of two buffers through named barriers and the byte
//     emission are the encoders' shared skeleton (sqz4_pair.cuh).
//
// The gang geometry (the second design, for Hopper's schedulers; the
// first ran a coder warp a block, its 32 lanes computing one chain,
// beside a producer warp, four pairs a CTA). Measured on that design
// (scripts/tok_timeline.py, clock64 spans of each warp's phases, PERF.md):
// the coder warp codes 99.8% of its time at 185 SM cycles an op and never
// waits for the producer, whose fill costs ~53 cycles an op; so one
// launch is the longest block's ops times the chain's latency, and
// putting two or three chains on a scheduler (several 512-block groups a
// launch) gained only 1.39x, because every chain brought a coder warp
// whose 32 identical lanes took the issue slots and the integer pipes the
// next chain needed (238-275 cycles an op at two a scheduler). A gang is
// kGang producer warps, one a block, and ONE coder warp whose lane b
// codes block b (code_gang): the chains share one instruction stream, so
// a scheduler holding several chains spends one chain's issue slots on
// their coding. Blocks advance in rounds: each producer fills its buffer,
// the coder codes the gang's buffers side by side, hands them back, and a
// finished block fills empty buffers until every block of the gang is
// done. At ~63 KB of shared memory and 96 registers a thread three gangs
// fit an SM, twelve chains (three a scheduler); a launch of one 512-block
// group (128 gangs, one an SM) runs as fast as the first design (12.47
// against 12.39 ms on the resident mix), and three groups a launch, which
// the resident encodes hand it (resident.LAUNCH_GROUPS), take 4.6 ms a
// group against 9.8-11.0 (NVIDIA H100 80GB HBM3, 700 W).
//   Also tried and measured slower, so not kept: a pair of ops (a
// literal's flag and byte) a coder trip from 16-byte pair slots, 7%
// slower an op than the one-op loop.
// What bounds it now: at one group, the chain's latency (185-187 SM
// cycles an op, 64-bit values as 32-bit pairs); at three chains a
// scheduler, 206 cycles an op, the three chains' latency plus the
// producers' issue (the coder warp's instructions are one chain's).
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
// budget. So TokProducer::match moves the cursor, and the next literal
// chunk seeks past whole 256-byte chunks that no literal reads (a run of
// matched cells) instead of staging them (Stager::skip_to); the mode is a
// template argument, and the cold instantiation compiles as before.

#include "sqz4_pair.cuh"

namespace sqz4 {

constexpr int kTokOps = 64;     // the most ops one token pass adds
// ops per hand-over buffer of a gang: 192 keeps a gang's shared memory
// under 76 KB, so three gangs fit an SM (other sizes are variants that
// scripts/tok_timeline.py builds)
#ifndef SQZ_RING_OPS
#define SQZ_RING_OPS 192
#endif
constexpr int kTokRingOps = SQZ_RING_OPS;
using TokRing = RingOf<kTokRingOps>;
constexpr int kLitPer = 32 / kLanes;   // literals of a chunk a lane holds

// a token producer's phase counters (Clocks, sqz4_pair.cuh), stored at
// slots kClockSlots..: literal staging, literal statistics, match tokens,
// token fetches, reciprocals; literals and match tokens (counts)
constexpr int kTokStage = 0, kTokLit = 1, kTokMatch = 2, kTokFetch = 3,
              kTokRecip = 4, kTokLits = 5, kTokMatches = 6;

struct TokSmemBody {
    uint32_t tok[2 * kStage];
    uint8_t lit_bytes[2 * kStage];
    int hist[256];
    PairBufsOf<kTokRingOps> pair;
};

// A gang's coder lanes read their blocks' buffers at the same offsets of
// consecutive TokSmem: a size of 32 past a multiple of 128 bytes puts the
// kGang lanes' 16-byte loads on distinct shared-memory banks.
constexpr int kTokPad = (160 - static_cast<int>(sizeof(TokSmemBody)) % 128)
                        % 128;
struct TokSmem : TokSmemBody {
    uint8_t pad[kTokPad ? kTokPad : 128];
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
    Clocks clk;

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
        clk.start();
    }

    // a literal flag (symbol s), in order
    SQZ_DEVICE void flag(TokRing& r, int i, int s) {
        const int a = md.lit0, b = md.lit1;
        entry(r, i, a + b, s ? a : 0, s ? b : a);
        md.lit0 += !s;
        md.lit1 += s;
    }

    template <int N>
    SQZ_DEVICE void model(LaneModel<N>& m, TokRing& r, int i, int s) {
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
    SQZ_DEVICE int match(TokRing& r, int n, uint32_t tok, int budget) {
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
            lidx += len;   // the next literal chunk seeks past the
                           // chunks of a run of matches (Stager::skip_to)
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
    SQZ_DEVICE void literals(TokRing& r, int n, int k) {
        if (kLitSkip) lits.skip_to(lidx);   // past the matched bytes
        lits.ensure(lidx + k - 1);
        clk.lap(kTokStage);
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
        clk.lap(kTokLit);
        clk.add(kTokLits, k);
    }

    // Fill buffer r (whole tokens or literal chunks, at most kTokRingOps
    // ops) and its reciprocals; returns true when this is the block's last
    // buffer.
    SQZ_DEVICE bool fill(TokRing& r) {
        int n = 0;
        r.flushes = 0;
        clk.mark();
        while (!done && n <= kTokRingOps - kTokOps) {
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
                clk.lap(kTokFetch);
                if (tok == 0) {
                    done = true;   // a pad: nothing more
                } else if ((tok >> 8) & 1) {
                    n += match(r, n, tok, budget);
                    clk.lap(kTokMatch);
                    clk.add(kTokMatches, 1);
                } else {
                    run = tok & 0xFF;
                }
            }
        }
        warp_sync();
        recips(r, n);
        r.n = n;
        r.last = done;
        warp_sync();
        clk.lap(kTokRecip);
        return done;
    }
};

// A gang's blocks (sqz4_pair.cuh): blocks n0 .. n0 + kGang - 1 of the
// launch, those below n_lanes, each from its token row (tok_rows tokens)
// and literal row (lit_bytes bytes); reads past either row see zeros, as
// the Pallas kernel's windows do. Block n = g * lanes + b writes column b
// of words[g] (rows `lanes` elements apart, zero-filled by the caller)
// and lens[g]. sm: kGang TokSmem, one a block. role: the warp's index in
// its gang on the card, 0 the coder and 1 + j block j's producer
// (encode_tok_run: one warp doing it all, the host).
struct TokGang {
    const uint32_t* toks;
    int tok_rows;
    const uint8_t* lits;
    int lit_bytes;
    int n_lanes, lanes, t_max;
    uint32_t* words;
    int cap_words;
    int32_t* lens;

    SQZ_DEVICE int blocks(long long n0) const {
        return n_lanes - n0 < kGang ? static_cast<int>(n_lanes - n0) : kGang;
    }

    // block n's payload column and length
    SQZ_DEVICE void column(long long n, uint32_t** w, int32_t** len) const {
        const long long g = n / lanes, b = n % lanes;
        *w = words + g * cap_words * lanes + b;
        *len = lens + g * 8 * lanes + b;
    }

    template <bool kLitSkip>
    SQZ_DEVICE void start(TokProducer<kLitSkip>& prod, TokSmem* s,
                          long long n) const {
        prod.init(s, toks + n * tok_rows, tok_rows, lits + n * lit_bytes,
                  lit_bytes, t_max);
    }
};

template <bool kLitSkip>
SQZ_DEVICE void encode_tok_gang(const TokGang& gg, long long n0,
                                TokSmem* sm, int role, volatile int* stop) {
    const int nblk = gg.blocks(n0);
    if (role == 0) {
        code_gang(sm, nblk, 1, stop);
        return;
    }
    const int j = role - 1;
    if (j >= nblk) {
        produce_gang<TokProducer<kLitSkip>>(nullptr, &sm[j].pair, 1, stop,
                                            gg.words, gg.lanes, gg.cap_words,
                                            gg.lens);
        return;
    }
    uint32_t* w;
    int32_t* len;
    gg.column(n0 + j, &w, &len);
    TokProducer<kLitSkip> prod;
    gg.start(prod, &sm[j], n0 + j);
    produce_gang(&prod, &sm[j].pair, 1, stop, w, gg.lanes, gg.cap_words,
                 len);
    prod.clk.store(kClockSlots);
}

// The same gang in one warp (the host's lane, or a warp of host threads):
// sqz4_pair.cuh run_gang.
template <bool kLitSkip>
SQZ_DEVICE void encode_tok_run(const TokGang& gg, long long n0,
                               TokSmem* sm) {
    const int nblk = gg.blocks(n0);
    TokProducer<kLitSkip> prods[kGang];
    ByteEmitter outs[kGang];
    int32_t* len_out[kGang];
    for (int j = 0; j < nblk; ++j) {
        uint32_t* w;
        gg.column(n0 + j, &w, &len_out[j]);
        gg.start(prods[j], &sm[j], n0 + j);
        outs[j] = ByteEmitter{w, gg.lanes, gg.cap_words, sm[j].pair.out, 0,
                              0};
    }
    run_gang(prods, sm, nblk, outs, len_out);
}

}  // namespace sqz4

#ifdef __CUDACC__

// One gang a CTA: kGang producer warps and a coder warp (warp 0),
// kGang blocks (sqz4_pair.cuh). At ~63 KB of shared memory and at most
// 96 registers a thread, three CTAs fit an SM: twelve chains, three
// coder warps.
template <bool kLitSkip>
__global__ void __launch_bounds__((sqz4::kGang + 1) * 32, 3)
sqz4_encode_tok_kernel(const uint32_t* __restrict__ toks, int tok_rows,
                       const uint8_t* __restrict__ lits, int lit_bytes,
                       int n_lanes, int lanes, int t_max,
                       uint32_t* __restrict__ words, int cap_words,
                       int32_t* __restrict__ lens) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ int stop;
    if (threadIdx.x == 0) stop = 0;
    __syncthreads();
    const sqz4::TokGang gg{toks, tok_rows, lits, lit_bytes, n_lanes, lanes,
                           t_max, words, cap_words, lens};
    sqz4::encode_tok_gang<kLitSkip>(
        gg, static_cast<long long>(blockIdx.x) * sqz4::kGang,
        reinterpret_cast<sqz4::TokSmem*>(smem_raw),
        static_cast<int>(threadIdx.x / 32), &stop);
}

// toks: [groups, lanes, tok_rows] u32; lits: [groups, lanes, lit_bytes]
// u8; words: [groups, cap_words, lanes] u32, zero-filled; lens: [groups,
// 8, lanes] i32, zero-filled. threads: (kGang + 1) * 32 a CTA, one gang.
// lit_skip nonzero: lits holds the raw blocks and match tokens skip the
// bytes they cover (the resident paths). Launches on `stream`; returns
// the cudaError_t of the launch.
extern "C" int sqz4_encode_tok_launch(const void* toks, int tok_rows,
                                      const void* lits, int lit_bytes,
                                      int groups, int lanes, int t_max,
                                      void* words, int cap_words, void* lens,
                                      int threads, int lit_skip,
                                      void* stream) {
    const long long n_lanes = static_cast<long long>(groups) * lanes;
    if (threads != (sqz4::kGang + 1) * 32)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_lanes == 0) return static_cast<int>(cudaSuccess);
    const auto kernel = lit_skip ? sqz4_encode_tok_kernel<true>
                                 : sqz4_encode_tok_kernel<false>;
    const size_t smem = sizeof(sqz4::TokSmem) * sqz4::kGang;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<(n_lanes + sqz4::kGang - 1) / sqz4::kGang, threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(toks), tok_rows,
        static_cast<const uint8_t*>(lits), lit_bytes,
        static_cast<int>(n_lanes), lanes, t_max,
        static_cast<uint32_t*>(words), cap_words,
        static_cast<int32_t*>(lens));
    return static_cast<int>(cudaGetLastError());
}

// The gangs an SM holds at once (*ctas) and the dynamic shared memory of
// one (*smem bytes), for the mode's kernel: the chains an SM is
// kGang * *ctas. Returns the cudaError_t of the query.
extern "C" int sqz4_encode_tok_occupancy(int lit_skip, int* ctas,
                                         int* smem) {
    const auto kernel = lit_skip ? sqz4_encode_tok_kernel<true>
                                 : sqz4_encode_tok_kernel<false>;
    *smem = static_cast<int>(sizeof(sqz4::TokSmem) * sqz4::kGang);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, kernel, (sqz4::kGang + 1) * 32, *smem));
}

#endif  // __CUDACC__
