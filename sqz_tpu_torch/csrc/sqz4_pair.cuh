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
// Geometry (the launchers' `threads`): 64 * k threads a CTA (k = 1..4)
// hold k blocks, coder warps 0..k-1 and producer warps k..2k-1, so at
// k = 4 each of an SM's four schedulers issues one coder chain (warps go
// to schedulers by their index mod 4); 32 threads, one block in one warp.
#pragma once

#include <stdint.h>

#include "sqz4_chain.cuh"

namespace sqz4 {

constexpr int kRingOps = 256;      // ops per hand-over buffer
constexpr int kRingFlushes = 8;    // the most flushes after them
constexpr int kRecs = kRingOps + kRingFlushes;
constexpr int kRoleBoth = 0, kRoleProducer = 1, kRoleConsumer = 2;
constexpr int kMaxBlocks = 4;      // blocks a CTA codes (four named
                                   // barriers each, of the 16)

// One buffer of coder ops (statistics and reciprocal) and the flushes that
// follow them, then the coder's records of their settled bytes.
struct Ring {
    u64 m[kRingOps];
    uint32_t total[kRingOps];
    uint32_t start[kRingOps];
    uint32_t size[kRingOps];
    u64 pre[kRecs];
    uint8_t cnt[kRecs];
    int n;
    int flushes;
    int last;
};

// A block's hand-over buffers and its emitter's ring of payload bytes.
struct PairBufs {
    uint32_t out[kOutBytes / 4];
    Ring ring[2];
};

SQZ_DEVICE void entry(Ring& r, int i, uint32_t total, uint32_t start,
                      uint32_t size) {
    r.total[i] = total;
    r.start[i] = start;
    r.size[i] = size;
}

// the reciprocals of entries [0, n), the lanes side by side
SQZ_DEVICE void recips(Ring& r, int n) {
    SQZ_UNROLL()
    for (int j = 0; j < kRingOps / kLanes; ++j) {
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
SQZ_DEVICE void drain(ChainCoder& c, Ring& r) {
    const int n = r.n;
    u64 m = r.m[0];
    uint32_t total = r.total[0], start = r.start[0], size = r.size[0];
    SQZ_UNROLL(4)
    for (int i = 0; i < n; ++i) {
        const int j = i + 1 < kRingOps ? i + 1 : i;
        const u64 m2 = r.m[j];
        const uint32_t total2 = r.total[j], start2 = r.start[j],
                       size2 = r.size[j];
        c.code(total, start, size, m, r.pre + i, r.cnt + i);
        m = m2, total = total2, start = start2, size = size2;
    }
    for (int i = n; i < n + r.flushes; ++i) c.flush(r.pre + i, r.cnt + i);
}

// The payload bytes of a coded buffer.
SQZ_DEVICE void emit(ByteEmitter& e, const Ring& r) {
    e.put(r.pre, r.cnt, r.n + r.flushes);
}

// The coder warp of a pair: code the buffers as the producer hands them
// over through named barriers bar .. bar + 3 (full 0 and 1, empty 0 and
// 1), until the last.
SQZ_DEVICE void code_buffers(PairBufs* pb, int bar) {
    const int threads = 2 * kLanes, full = bar, empty = bar + 2;
    ChainCoder coder{0ull, ~0ull};
    for (int c = 0;; ++c) {
        bar_wait(full + (c & 1), threads);
        drain(coder, pb->ring[c & 1]);
        const bool last = pb->ring[c & 1].last;
        bar_arrive(empty + (c & 1), threads);
        if (last) break;
    }
}

// The producer warp of a pair (role kRoleProducer), or one warp doing
// both in turn (kRoleBoth): fill buffers, turn their records into the
// payload words of one lane's column (rows `lanes` elements apart,
// zero-filled by the caller; bytes past cap_words words are dropped) and
// store the byte length (which may exceed the capacity) to *len_out.
template <class P>
SQZ_DEVICE void produce_buffers(P& prod, PairBufs* pb, int role, int bar,
                                uint32_t* words, int lanes, int cap_words,
                                int32_t* len_out) {
    const int threads = 2 * kLanes, full = bar, empty = bar + 2;
    ByteEmitter out{words, lanes, cap_words, pb->out, 0, 0};
    if (role == kRoleProducer) {
        // buffer c & 1 is refilled once the coder hands it back, and its
        // records turned into bytes first
        int c = 0;
        for (;; ++c) {
            if (c >= 2) {
                bar_wait(empty + (c & 1), threads);
                emit(out, pb->ring[c & 1]);
            }
            const bool last = prod.fill(pb->ring[c & 1]);
            bar_arrive(full + (c & 1), threads);
            if (last) break;
        }
        // the coder's hand-backs of the last two buffers
        for (int k = c >= 1 ? c - 1 : c; k <= c; ++k) {
            bar_wait(empty + (k & 1), threads);
            emit(out, pb->ring[k & 1]);
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
