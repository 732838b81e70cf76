// The two-warp skeleton of the sqz4 encoders (token, op-stream and
// stats-fed): a producer warp turns a block's input into coder ops with
// their statistics (start, size, total) and reciprocals in a buffer of
// kRingOps ops in shared memory; a coder warp runs only the coder
// arithmetic on them (ChainCoder, sqz4_chain.cuh) and records each op's
// settled bytes; the producer turns the records into payload words
// (ByteEmitter) when the buffer comes back, before refilling it. Two
// buffers go back and forth through named barriers.
//
// An encoder supplies its producer: a type with
//   bool fill(Ring& r)   // fill r (ops, flushes, reciprocals via
//                        // recips()); true when r is the block's last
// and calls code_buffers() in the coder warp and produce_buffers() in
// the producer warp (or in the one warp of a 32-thread CTA, and on the
// host, which produce a buffer and then code it).
//
// Pair geometry (the op-stream and stats-fed launchers' `threads`): 64 *
// k threads a CTA (k = 1..4) hold k blocks, coder warps 0..k-1 and
// producer warps k..2k-1, so at k = 4 each of an SM's four schedulers
// issues one coder chain (warps go to schedulers by their index mod 4);
// 32 threads, one block in one warp. A pair's coder warp computes one
// chain on all 32 lanes.
//
// Gang geometry (the token encoder): kGang producer warps, one a block,
// and one coder warp whose lane b codes block b (code_gang,
// produce_gang): one coder instruction advances kGang chains, so a
// scheduler that holds several chains spends one chain's issue slots and
// pipes on their coding. The gang codes in rounds: every producer fills
// its buffer, the coder codes them all, side by side, and hands them
// back; a block that is done fills empty buffers until the round in which
// every block's last buffer was coded.
#pragma once

#include <stdint.h>

#include "sqz4_chain.cuh"

namespace sqz4 {

constexpr int kRingOps = 256;      // ops per hand-over buffer of a pair
constexpr int kRingFlushes = 8;    // the most flushes after them
constexpr int kRoleBoth = 0, kRoleProducer = 1, kRoleConsumer = 2;
constexpr int kMaxBlocks = 4;      // blocks a CTA codes (four named
                                   // barriers each, of the 16)

// Phase cycle counters for a timeline build (scripts/tok_timeline.py
// compiles with -DSQZ_PAIR_CLOCKS and defines, before this header,
// sqz_pair_clock_store(base, t), which stores a warp's kClockSlots sums
// at slots base..): a warp sums clock64() spans of its phases in
// registers and stores them once, at its end. In every other build the
// counters compile to nothing.
constexpr int kClockSlots = 8;
#ifdef SQZ_PAIR_CLOCKS
struct Clocks {
    long long t[kClockSlots];
    long long at;
    SQZ_DEVICE void start() {
        SQZ_UNROLL()
        for (int k = 0; k < kClockSlots; ++k) t[k] = 0;
        at = clock64();
    }
    SQZ_DEVICE void mark() { at = clock64(); }
    // the cycles since the last mark or lap to phase k
    SQZ_DEVICE void lap(int k) {
        const long long now = clock64();
        t[k] += now - at;
        at = now;
    }
    SQZ_DEVICE void add(int k, long long n) { t[k] += n; }
    SQZ_DEVICE void store(int base) { sqz_pair_clock_store(base, t); }
};
#else
struct Clocks {
    SQZ_DEVICE void start() {}
    SQZ_DEVICE void mark() {}
    SQZ_DEVICE void lap(int) {}
    SQZ_DEVICE void add(int, long long) {}
    SQZ_DEVICE void store(int) {}
};
#endif
// the counters' phases: a coder warp's (code_buffers), a producer warp's
// (produce_buffers) and a token producer's fill (sqz4_encode_tok.cu)
constexpr int kClkWait = 0, kClkCode = 1, kClkOps = 2, kClkHand = 3;
constexpr int kClkEmit = 1, kClkFill = 2, kClkFinish = 4;

// One buffer of kOps coder ops (statistics and reciprocal; kOps a
// multiple of kLanes) and the flushes that follow them, then the coder's
// records of their settled bytes.
template <int kOps>
struct RingOf {
    static constexpr int kRecs = kOps + kRingFlushes;
    u64 m[kOps];
    uint32_t total[kOps];
    uint32_t start[kOps];
    uint32_t size[kOps];
    u64 pre[kRecs];
    uint8_t cnt[kRecs];
    int n;
    int flushes;
    int last;
};

// A block's hand-over buffers and its emitter's ring of payload bytes;
// in a gang also its coder's registers between rounds and whether its
// last buffer was coded (the coder warp's alone).
template <int kOps>
struct PairBufsOf {
    u64 low, rng;
    int coded_last;
    uint32_t out[kOutBytes / 4];
    RingOf<kOps> ring[2];
};

// a pair's buffers (the op-stream and stats-fed encoders)
using Ring = RingOf<kRingOps>;
using PairBufs = PairBufsOf<kRingOps>;

template <int kOps>
SQZ_DEVICE void entry(RingOf<kOps>& r, int i, uint32_t total,
                      uint32_t start, uint32_t size) {
    r.total[i] = total;
    r.start[i] = start;
    r.size[i] = size;
}

// the reciprocals of entries [0, n), the lanes side by side
template <int kOps>
SQZ_DEVICE void recips(RingOf<kOps>& r, int n) {
    SQZ_UNROLL()
    for (int j = 0; j < kOps / kLanes; ++j) {
        const int i = lane_id() + j * kLanes;
        if (i < n) r.m[i] = recip64(r.total[i]);
    }
}

// Which ops of a window of kLanes ops (lane l holds op l; masks of the
// coded ops and the flushes; pads code nothing) join a buffer that holds
// *flushes flushes so far: the coded ops of the lanes below `seg`, then
// the flushes up to the next coded op, at most kRingFlushes in all. A
// buffer ends (`end`) at the first coded op after its flushes, or when
// its room for them is full: the coder's loop over a buffer's ops then
// has no branch, and its flushes follow its ops as in the stream. `adv`:
// the ops of the window consumed.
struct Take {
    int seg;
    int adv;
    bool end;
};

SQZ_DEVICE Take take_window(unsigned coded, unsigned flush, int* flushes) {
    const int from = *flushes ? 0 : lowest(flush);
    if (from >= kLanes) return Take{kLanes, kLanes, false};
    const unsigned rest = ~below(from);
    const int next = lowest(coded & rest);
    unsigned run = flush & rest & below(next);
    const int room = kRingFlushes - *flushes;
    if (popc(run) > room) {
        int adv = 0;
        for (int k = 0; k < room; ++k) {
            adv = lowest(run) + 1;
            run &= run - 1;
        }
        *flushes = kRingFlushes;
        return Take{from, adv, true};
    }
    *flushes += popc(run);
    return Take{from, next, next < kLanes};
}

// Fill buffer r from a producer that takes its input kLanes items at a
// time: prod.window(r, &n, &flushes) adds one window's coded ops at
// entries n.. and its flushes (take_window), advances, sets prod.done at
// the input's end and returns true when the window ends the buffer.
// Then the reciprocals; returns true when r is the block's last buffer.
template <class P>
SQZ_DEVICE bool fill_windows(P& prod, Ring& r) {
    int n = 0, flushes = 0;
    while (!prod.done && n <= kRingOps - kLanes)
        if (prod.window(r, &n, &flushes)) break;
    warp_sync();
    recips(r, n);
    r.n = n;
    r.flushes = flushes;
    r.last = prod.done;
    warp_sync();
    return prod.done;
}

// Code one buffer of ops, then its flushes, recording their settled
// bytes. Each op's entry is read while the op before it is coded, so no
// load waits on the chain.
template <int kOps>
SQZ_DEVICE void drain(ChainCoder& c, RingOf<kOps>& r) {
    const int n = r.n;
    u64 m = r.m[0];
    uint32_t total = r.total[0], start = r.start[0], size = r.size[0];
    SQZ_UNROLL(4)
    for (int i = 0; i < n; ++i) {
        const int j = i + 1 < kOps ? i + 1 : i;
        const u64 m2 = r.m[j];
        const uint32_t total2 = r.total[j], start2 = r.start[j],
                       size2 = r.size[j];
        c.code(total, start, size, m, r.pre + i, r.cnt + i);
        m = m2, total = total2, start = start2, size = size2;
    }
    for (int i = n; i < n + r.flushes; ++i) c.flush(r.pre + i, r.cnt + i);
}

// The payload bytes of a coded buffer.
template <int kOps>
SQZ_DEVICE void emit(ByteEmitter& e, const RingOf<kOps>& r) {
    e.put(r.pre, r.cnt, r.n + r.flushes);
}

// The coder warp of a pair: code the buffers as the producer hands them
// over through named barriers bar .. bar + 3 (full 0 and 1, empty 0 and
// 1), until the last.
template <int kOps>
SQZ_DEVICE void code_buffers(PairBufsOf<kOps>* pb, int bar) {
    const int threads = 2 * kLanes, full = bar, empty = bar + 2;
    ChainCoder coder{0ull, ~0ull};
    Clocks ck;
    ck.start();
    for (int c = 0;; ++c) {
        bar_wait(full + (c & 1), threads);
        ck.lap(kClkWait);
        drain(coder, pb->ring[c & 1]);
        ck.lap(kClkCode);
        ck.add(kClkOps, pb->ring[c & 1].n + pb->ring[c & 1].flushes);
        const bool last = pb->ring[c & 1].last;
        bar_arrive(empty + (c & 1), threads);
        ck.lap(kClkHand);
        if (last) break;
    }
    ck.store(0);
}

// The producer warp of a pair (role kRoleProducer), or one warp doing
// both in turn (kRoleBoth): fill buffers, turn their records into the
// payload words of one lane's column (rows `lanes` elements apart,
// zero-filled by the caller; bytes past cap_words words are dropped) and
// store the byte length (which may exceed the capacity) to *len_out.
template <class P, int kOps>
SQZ_DEVICE void produce_buffers(P& prod, PairBufsOf<kOps>* pb, int role,
                                int bar, uint32_t* words, int lanes,
                                int cap_words, int32_t* len_out) {
    const int threads = 2 * kLanes, full = bar, empty = bar + 2;
    ByteEmitter out{words, lanes, cap_words, pb->out, 0, 0};
    Clocks ck;
    ck.start();
    if (role == kRoleProducer) {
        // buffer c & 1 is refilled once the coder hands it back, and its
        // records turned into bytes first
        int c = 0;
        for (;; ++c) {
            if (c >= 2) {
                bar_wait(empty + (c & 1), threads);
                ck.lap(kClkWait);
                emit(out, pb->ring[c & 1]);
                ck.lap(kClkEmit);
            }
            const bool last = prod.fill(pb->ring[c & 1]);
            ck.lap(kClkFill);
            bar_arrive(full + (c & 1), threads);
            ck.lap(kClkHand);
            if (last) break;
        }
        // the coder's hand-backs of the last two buffers
        for (int k = c >= 1 ? c - 1 : c; k <= c; ++k) {
            bar_wait(empty + (k & 1), threads);
            ck.lap(kClkWait);
            emit(out, pb->ring[k & 1]);
            ck.lap(kClkEmit);
        }
    } else {
        ChainCoder coder{0ull, ~0ull};
        for (;;) {
            const bool last = prod.fill(pb->ring[0]);
            drain(coder, pb->ring[0]);
            warp_sync();
            emit(out, pb->ring[0]);
            if (last) break;
        }
    }
    const int32_t n = out.finish();
    if (lane_id() == 0) *len_out = n;
    ck.lap(kClkFinish);
    ck.store(0);
}

// blocks a gang: producer warps, coder lanes (other sizes are variants)
#ifndef SQZ_GANG
#define SQZ_GANG 4
#endif
constexpr int kGang = SQZ_GANG;

// The gang's blocks' coder lanes: lane b codes block b's buffer of round
// c (every lane on the card; the host's one lane loops over the blocks)
// and counts its ops in ck. Blocks at or past nblk have none. Returns
// true when every block's last buffer has been coded, the same on every
// lane. Each block's registers wait in its PairBufs between rounds (two
// loads and two stores a round).
template <class S>
SQZ_DEVICE bool code_round(S* sm, int nblk, int c, Clocks& ck) {
    bool all = true;
    for (int b = lane_id(); b < kGang; b += kLanes) {
        if (b >= nblk) continue;
        auto& p = sm[b].pair;
        if (!p.coded_last) {
            auto& r = p.ring[c & 1];
            ChainCoder coder{p.low, p.rng};
            drain(coder, r);
            ck.add(kClkOps, r.n + r.flushes);
            p.low = coder.low;
            p.rng = coder.rng;
            p.coded_last = r.last;
        }
        all = all && p.coded_last;
    }
    return ballot(!all) == 0;
}

// The coder registers of the gang's blocks, before the first round.
template <class S>
SQZ_DEVICE void start_coders(S* sm) {
    for (int b = lane_id(); b < kGang; b += kLanes) {
        sm[b].pair.low = 0ull;
        sm[b].pair.rng = ~0ull;
        sm[b].pair.coded_last = 0;
    }
}

// An empty buffer: a block that is done, or a producer warp of a gang
// with fewer blocks.
template <int kOps>
SQZ_DEVICE void empty_ring(RingOf<kOps>& r) {
    warp_sync();
    r.n = 0;
    r.flushes = 0;
    r.last = 1;
    warp_sync();
}

// The coder warp of a gang (warp 0 of its CTA), named barriers full = bar,
// bar + 1 and empty = bar + 2, bar + 3 over the gang's kGang + 1 warps:
// round c waits for every producer's buffer c & 1, codes them
// (code_round) and hands them back. After the round S in which every
// block's last buffer was coded it sets *stop = S + 1, hands back, and
// takes the producers' round S + 1 of empty buffers, so that every
// arrival at a barrier is matched. The coder runs at most one round ahead
// of a producer's emission, so a producer that has emitted round c - 2
// reads *stop as 0, c - 1 (S = c - 2: its last round) or c.
template <class S>
SQZ_DEVICE void code_gang(S* sm, int nblk, int bar, volatile int* stop) {
    const int threads = (kGang + 1) * kLanes, full = bar, empty = bar + 2;
    Clocks ck;
    ck.start();
    start_coders(sm);
    for (int c = 0;; ++c) {
        bar_wait(full + (c & 1), threads);
        ck.lap(kClkWait);
        const bool all = code_round(sm, nblk, c, ck);
        ck.lap(kClkCode);
        if (all && lane_id() == 0) *stop = c + 1;
        bar_arrive(empty + (c & 1), threads);
        ck.lap(kClkHand);
        if (all) {
            bar_wait(full + ((c + 1) & 1), threads);
            break;
        }
    }
    ck.store(0);
}

// A producer warp of a gang (prod null: a warp with no block): fill
// buffer c & 1 each round, after turning the records of round c - 2 in it
// into payload words (ByteEmitter, as produce_buffers), until it has
// turned those of the coder's last round (*stop, code_gang); then the
// last partial word and the byte length to *len_out.
template <class P, int kOps>
SQZ_DEVICE void produce_gang(P* prod, PairBufsOf<kOps>* pb, int bar,
                             const volatile int* stop, uint32_t* words,
                             int lanes, int cap_words, int32_t* len_out) {
    const int threads = (kGang + 1) * kLanes, full = bar, empty = bar + 2;
    ByteEmitter out{words, lanes, cap_words, pb->out, 0, 0};
    bool done = prod == nullptr;
    Clocks ck;
    ck.start();
    for (int c = 0;; ++c) {
        if (c >= 2) {
            bar_wait(empty + (c & 1), threads);
            ck.lap(kClkWait);
            if (prod) emit(out, pb->ring[c & 1]);
            ck.lap(kClkEmit);
            if (*stop == c - 1) break;   // round c - 2 was the last
        }
        if (done) empty_ring(pb->ring[c & 1]);
        else done = prod->fill(pb->ring[c & 1]);
        ck.lap(kClkFill);
        bar_arrive(full + (c & 1), threads);
        ck.lap(kClkHand);
    }
    if (prod) {
        const int32_t n = out.finish();
        if (lane_id() == 0) *len_out = n;
    }
    ck.lap(kClkFinish);
    ck.store(0);
}

// A gang in one warp (the host): each round, every block's producer
// fills its buffer 0, the coder lanes code them, and their records become
// payload words, until every block's last buffer is coded.
template <class P, class S>
SQZ_DEVICE void run_gang(P* prods, S* sm, int nblk, ByteEmitter* outs,
                         int32_t* const* len_out) {
    start_coders(sm);
    Clocks ck;
    bool done[kGang] = {};
    for (;;) {
        for (int b = 0; b < nblk; ++b) {
            if (done[b]) empty_ring(sm[b].pair.ring[0]);
            else done[b] = prods[b].fill(sm[b].pair.ring[0]);
        }
        warp_sync();
        const bool all = code_round(sm, nblk, 0, ck);
        warp_sync();
        for (int b = 0; b < nblk; ++b) emit(outs[b], sm[b].pair.ring[0]);
        if (all) break;
    }
    for (int b = 0; b < nblk; ++b) {
        const int32_t n = outs[b].finish();
        if (lane_id() == 0) *len_out[b] = n;
    }
}

#ifdef __CUDACC__

// Where a warp of a pair kernel sits: its block (blockIdx.x * blocks a
// CTA + j), its slot j in the CTA and its role.
struct PairSlot {
    int n;
    int j;
    int role;
};

SQZ_DEVICE PairSlot pair_slot() {
    const int per = blockDim.x == 32 ? 1 : blockDim.x / 64;
    const int warp = threadIdx.x / 32, j = warp % per;
    return PairSlot{static_cast<int>(blockIdx.x) * per + j, j,
                    blockDim.x == 32 ? kRoleBoth
                    : warp < per     ? kRoleConsumer
                                     : kRoleProducer};
}

// Launch a pair kernel over n_lanes blocks at `threads` a CTA (32, or 64
// to 64 * kMaxBlocks in steps of 64), with smem_block bytes of dynamic
// shared memory a block. Returns the cudaError_t of the launch.
template <typename... P, typename... A>
int pair_launch(void (*kernel)(P...), size_t smem_block, int n_lanes,
                int threads, void* stream, A... args) {
    if (threads != 32 && (threads % 64 || threads < 64
                          || threads > 64 * kMaxBlocks))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_lanes == 0) return static_cast<int>(cudaSuccess);
    const int per = threads == 32 ? 1 : threads / 64;
    const size_t smem = smem_block * per;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<(n_lanes + per - 1) / per, threads, smem,
             static_cast<cudaStream_t>(stream)>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__

}  // namespace sqz4
