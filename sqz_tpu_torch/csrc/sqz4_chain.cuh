// The coder pieces of the sqz4 kernels (the three encoders and the
// decoder): models, coder step and byte streams built so that each
// block's serial chain holds only the coder arithmetic.
//
// - The divide by a model total is sqz4_div.cuh's high multiply by a
//   reciprocal computed off the chain.
// - The models live in the registers of the warp's 32 lanes (LaneModel,
//   LaneBinary): a 256-symbol model as eight symbols a lane, so a
//   symbol's statistics are a shuffle, a search is eight compares a lane
//   and one warp sum (a Fenwick tree in shared memory takes eight
//   dependent loads), and an update is a predicated add a lane.
// - The decoder searches in the scaled domain: for an integer count c,
//   c <= floor(diff / rd) exactly when c * rd <= diff, so a symbol comes
//   from products and compares and needs no second divide.
// - The encoder's coder step records its settled bytes (ChainCoder) and
//   a warp places them in the payload 32 records at a time (ByteEmitter).
//   The decoder's bytes come in through a 64-bit cache refilled from a
//   staged copy of its payload column (ByteReader). Inputs are staged in
//   shared memory a chunk at a time by the warp's lanes, a chunk ahead of
//   use (Stager).
//
// The integer values are those of the reference models (FORMAT.md §2.3:
// every count starts at 1, or at a warm block's seed (§3.1), and grows by
// one a coded symbol), so every statistic, and with it every byte, is the
// same.
#pragma once

#include <stdint.h>

#include "sqz4_coder.cuh"
#include "sqz4_div.cuh"
#include "sqz4_warp.cuh"

namespace sqz4 {

// A warm block's seed (sqzt v2 and v3, FORMAT.md §3.1): block 0's (or the
// anchor's) final rescaled model counts, int32 words in the reference's
// csum form (sqz4_pallas.py _enc_seed_table): the inclusive running sums
// of the byte, size and bits models' counts, the literal flag's counts of
// 0 and 1, the distance-bit models' counts of 0, then of 1. Each model's
// total is at most 2^14 after the rescale; a block of up to
// 2^kMaxBlockBits bytes keeps it below kTotalLimit, inside the range where
// recip64 is exact (sqz4_div.cuh).
constexpr int kSeedByte = 0, kSeedSize = 256, kSeedBits = 512,
              kSeedLit = 544, kSeedDist0 = 546, kSeedDist1 = 578,
              kSeedWords = 610;

// An adaptive model of N symbols (N a multiple of kLanes) spread over the
// warp's lanes, in registers: lane l holds the counts of symbols
// l * kPer .. l * kPer + kPer - 1 as an inclusive running sum (cum) and
// the count of every symbol below them (base). A symbol's statistics come
// from its lane by a shuffle; a scaled search counts the symbols whose
// start is in on every lane and sums the counts across the warp; an
// update is a predicated add on each lane. No shared memory, so no
// read-modify-write between lanes. Every lane calls every method with the
// same arguments (the host's single lane holds all N symbols).
template <int N>
struct LaneModel {
    static constexpr int kPer = N / kLanes;
    int base;
    int cum[kPer];
    int total;   // the same on every lane

    SQZ_DEVICE void init() {
        SQZ_UNROLL()
        for (int k = 0; k < kPer; ++k) cum[k] = k + 1;
        base = lane_id() * kPer;
        total = N;
    }

    // warm: from csum, the inclusive running sums of the N counts
    SQZ_DEVICE void init(const int32_t* csum) {
        const int lo = lane_id() * kPer;
        base = lo ? csum[lo - 1] : 0;
        SQZ_UNROLL()
        for (int k = 0; k < kPer; ++k) cum[k] = csum[lo + k] - base;
        total = csum[N - 1];
    }

    // start and size of symbol s. cum[j - 1] and cum[j] are taken as the
    // largest entry below j and the least from j on (cum increases): a
    // compiler turns a select by index into an indexed load, which would
    // move the array out of registers.
    SQZ_DEVICE void stats(int s, int* start, int* size) const {
        const int j = s % kPer;
        int lo = 0, hi = cum[kPer - 1];
        SQZ_UNROLL()
        for (int k = 0; k < kPer; ++k) {
            lo = k < j && cum[k] > lo ? cum[k] : lo;
            hi = k >= j && cum[k] < hi ? cum[k] : hi;
        }
        *start = shfl(base + lo, s / kPer);
        *size = shfl(hi - lo, s / kPer);
    }

    // start and size of symbol s, which may differ from lane to lane
    SQZ_DEVICE void stats_any(int s, int* start, int* size) const {
        const int o = s / kPer, j = s % kPer;
        int lo = 0, hi = 0x7fffffff;
        SQZ_UNROLL()
        for (int k = 0; k < kPer; ++k) {
            const int v = shfl(cum[k], o);
            lo = k < j && v > lo ? v : lo;
            hi = k >= j && v < hi ? v : hi;
        }
        *start = shfl(base, o) + lo;
        *size = hi - lo;
    }

    // n updates at once: inc[k] more of this lane's symbol k
    SQZ_DEVICE void add(const int inc[kPer], int n) {
        int run = 0;
        SQZ_UNROLL()
        for (int k = 0; k < kPer; ++k) {
            run += inc[k];
            cum[k] += run;
        }
        base += warp_exscan(run);
        total += n;
    }

    SQZ_DEVICE void bump(int s) {
        const int o = s / kPer, j = s % kPer, lane = lane_id();
        base += lane > o;
        SQZ_UNROLL()
        for (int k = 0; k < kPer; ++k) cum[k] += lane == o && k >= j;
        ++total;
    }

    // The symbol whose [start, start + size) scaled by rd holds diff: the
    // count of symbols with start * rd <= diff, less one (N - 1 when diff
    // lies past total * rd, as the reference saturates).
    SQZ_DEVICE int search(u64 diff, u64 rd, int* start, int* size) const {
        int n = 0;
        SQZ_UNROLL()
        for (int k = 0; k < kPer; ++k)
            n += static_cast<u64>(base + (k ? cum[k - 1] : 0)) * rd <= diff;
        const int sym = warp_sum(n) - 1;
        stats(sym, start, size);
        return sym;
    }
};

// N binary models (counts of 0 and of 1) spread over the lanes as above.
template <int N>
struct LaneBinary {
    static constexpr int kPer = N / kLanes;
    int f0[kPer];
    int f1[kPer];

    SQZ_DEVICE void init() {
        SQZ_UNROLL()
        for (int k = 0; k < kPer; ++k) f0[k] = f1[k] = 1;
    }

    // warm: model i's counts n0[i] and n1[i]
    SQZ_DEVICE void init(const int32_t* n0, const int32_t* n1) {
        SQZ_UNROLL()
        for (int k = 0; k < kPer; ++k) {
            f0[k] = n0[lane_id() * kPer + k];
            f1[k] = n1[lane_id() * kPer + k];
        }
    }

    // the counts of model i (the masked sums keep the arrays in
    // registers, as in LaneModel::stats)
    SQZ_DEVICE void get(int i, int* a, int* b) const {
        const int j = i % kPer;
        int x = 0, y = 0;
        SQZ_UNROLL()
        for (int k = 0; k < kPer; ++k) {
            x += f0[k] & -(k == j);
            y += f1[k] & -(k == j);
        }
        *a = shfl(x, i / kPer);
        *b = shfl(y, i / kPer);
    }

    // the counts of model i, which may differ from lane to lane
    SQZ_DEVICE void get_any(int i, int* a, int* b) const {
        const int o = i / kPer, j = i % kPer;
        int x = 0, y = 0;
        SQZ_UNROLL()
        for (int k = 0; k < kPer; ++k) {
            const int v0 = shfl(f0[k], o), v1 = shfl(f1[k], o);
            x += v0 & -(k == j);
            y += v1 & -(k == j);
        }
        *a = x;
        *b = y;
    }

    // n0[k] more zeros and n1[k] more ones of this lane's model k
    SQZ_DEVICE void add(const int n0[kPer], const int n1[kPer]) {
        SQZ_UNROLL()
        for (int k = 0; k < kPer; ++k) {
            f0[k] += n0[k];
            f1[k] += n1[k];
        }
    }

    SQZ_DEVICE void bump(int i, int sym) {
        const bool mine = lane_id() == i / kPer;
        SQZ_UNROLL()
        for (int k = 0; k < kPer; ++k) {
            const bool hit = mine && k == i % kPer;
            f0[k] += hit && !sym;
            f1[k] += hit && sym;
        }
    }
};

// The models of one sqz4 block (FORMAT.md §2.3): the byte and size
// models, the 32-entry bits model, the 32 distance-bit models and the
// literal flag (counts of 0 and 1, the same on every lane).
struct LaneModels {
    LaneModel<256> byte;
    LaneModel<256> size;
    LaneModel<32> bits;
    LaneBinary<32> dist;
    int lit0, lit1;

    // cold: every count 1
    SQZ_DEVICE void init() {
        byte.init();
        size.init();
        bits.init();
        dist.init();
        lit0 = lit1 = 1;
    }

    // warm from a seed (kSeed* layout), or cold where seed is null
    SQZ_DEVICE void init(const int32_t* seed) {
        if (!seed) {
            init();
            return;
        }
        byte.init(seed + kSeedByte);
        size.init(seed + kSeedSize);
        bits.init(seed + kSeedBits);
        dist.init(seed + kSeedDist0, seed + kSeedDist1);
        lit0 = seed[kSeedLit];
        lit1 = seed[kSeedLit + 1];
    }
};

// The encoder's coder registers and its step on precomputed statistics.
// A step does not emit its settled bytes: it records them as (pre, cnt),
// the top cnt bytes of pre (past 8: zeros), and a ByteEmitter turns the
// records into the payload off the chain.
struct ChainCoder {
    u64 low;
    u64 rng;

    // One op: narrow to [start, start + size) of total (m =
    // recip64(total)), renormalize with the underflow escape, and record
    // the settled bytes: the reference coder's arithmetic (sqz4_ref.py
    // _Coder.code_stats) with no divide and no branch. The range stays
    // above total, so the quotient is at least one, the new range nonzero
    // and at most seven bytes settle (no shift but the escape's reaches 64
    // bits).
    SQZ_DEVICE void code(uint32_t total, uint32_t start, uint32_t size,
                         u64 m, u64* pre, uint8_t* cnt) {
        // q = rng / total: the products for the estimate and for one more
        // go on while the remainder test decides between them
        const u64 qe = mulhi64(rng, m);
        const bool up = div_up(rng, total, qe);
        const u64 lo_e = low + start * qe, rg_e = size * qe;
        const u64 lo = up ? lo_e + start : lo_e;
        const u64 rg = up ? rg_e + size : rg_e;
        const int c = lead_zero_bytes(lo ^ (lo + rg));
        const u64 l2 = lo << (8 * c), r2 = rg << (8 * c);
        const bool uf = r2 <= total;   // underflow: two more bytes
        low = uf ? shl(lo, 8 * c + 16) : l2;
        rng = uf ? ~low : r2;
        *pre = lo;
        *cnt = static_cast<uint8_t>(c + 2 * uf);
    }

    // exactly one emission of the top byte
    SQZ_DEVICE void flush(u64* pre, uint8_t* cnt) {
        *pre = low;
        *cnt = 1;
        low <<= 8;
    }
};

constexpr int kOutBytes = 1024;   // bytes of an emitter's ring (2^k)

// Big-endian payload bytes from coder records into one lane's column of
// words: the warp's lanes take 32 records at a time, place their bytes
// side by side in a ring in shared memory (offsets from a warp scan of
// the counts) and copy the completed words to the column.
struct ByteEmitter {
    uint32_t* out;
    int stride;
    int cap_words;
    uint32_t* ring;   // kOutBytes / 4 words of shared memory
    int pos;          // bytes so far
    int done;         // words copied to the column so far

    // words [done, end) of the ring to the column (those that fit)
    SQZ_DEVICE void copy_words(int end) {
        warp_sync();
        for (int w = done + lane_id(); w < end; w += kLanes)
            if (w < cap_words)
                out[static_cast<long long>(w) * stride] =
                    bswap32(ring[w & (kOutBytes / 4 - 1)]);
        warp_sync();
        done = end;
    }

    // the bytes of records [0, n)
    SQZ_DEVICE void put(const u64* pre, const uint8_t* cnt, int n) {
        constexpr int kPer = 32 / kLanes;
        uint8_t* bytes = reinterpret_cast<uint8_t*>(ring);
        for (int base = 0; base < n; base += 32) {
            int c[kPer], mine = 0;
            SQZ_UNROLL()
            for (int q = 0; q < kPer; ++q) {
                const int i = base + lane_id() * kPer + q;
                c[q] = i < n ? cnt[i] : 0;
                mine += c[q];
            }
            int at = pos + warp_exscan(mine);
            SQZ_UNROLL()
            for (int q = 0; q < kPer; ++q) {
                const u64 p = c[q] ? pre[base + lane_id() * kPer + q] : 0;
                for (int k = 0; k < c[q]; ++k)
                    bytes[(at + k) & (kOutBytes - 1)] = static_cast<uint8_t>(
                        k < 8 ? p >> (56 - 8 * k) : 0);
                at += c[q];
            }
            pos += warp_sum(mine);
            copy_words(pos >> 2);
        }
    }

    // Write the last partial word (zero-padded); returns the byte count
    // (which may exceed the column's capacity: bytes past it are dropped).
    SQZ_DEVICE int32_t finish() {
        uint8_t* bytes = reinterpret_cast<uint8_t*>(ring);
        warp_sync();
        if (lane_id() == 0)
            for (int k = pos; k & 3; ++k) bytes[k & (kOutBytes - 1)] = 0;
        copy_words((pos + 3) >> 2);
        return pos;
    }
};

constexpr int kStage = 256;   // elements per staging chunk

// A row of `len` elements `stride` apart in device memory, read in order
// through a window of two kStage-element chunks in shared memory (buf
// holds 2 * kStage); the next chunk waits in the lanes' registers, loaded
// a whole chunk before it is needed (coalesced when stride is 1). Reads
// past the row see zeros. ensure() is called by every lane with the same
// index; at() may then read any element of that chunk or the one before.
template <typename T>
struct Stager {
    const T* row;
    int len;
    int stride;
    T* buf;
    int hi;   // the newest chunk in buf
    T pre[kStage / kLanes];

    SQZ_DEVICE void fetch(int c) {
        SQZ_UNROLL()
        for (int i = 0; i < kStage / kLanes; ++i) {
            const int idx = c * kStage + lane_id() + i * kLanes;
            pre[i] = idx < len ? row[static_cast<long long>(idx) * stride]
                               : T(0);
        }
    }

    SQZ_DEVICE void commit(int c) {
        warp_sync();
        SQZ_UNROLL()
        for (int i = 0; i < kStage / kLanes; ++i)
            buf[(c & 1) * kStage + lane_id() + i * kLanes] = pre[i];
        warp_sync();
    }

    SQZ_DEVICE void init(const T* r, int n, int s, T* b) {
        row = r, len = n, stride = s, buf = b, hi = 0;
        fetch(0);
        commit(0);
        fetch(1);
    }

    SQZ_DEVICE void ensure(int idx) {
        while (idx / kStage > hi) {   // indices only grow
            commit(++hi);
            fetch(hi + 1);
        }
    }

    // Past whole chunks that no read needs (idx's chunk more than one
    // ahead of the window): load idx's chunk now, for the next ensure()
    // to commit, and stage none of the chunks between.
    SQZ_DEVICE void skip_to(int idx) {
        const int c = idx / kStage;
        if (c > hi + 1) {
            hi = c - 1;
            fetch(c);
        }
    }

    SQZ_DEVICE T at(int idx) const { return buf[idx % (2 * kStage)]; }

    SQZ_DEVICE T get(int idx) {
        ensure(idx);
        return at(idx);
    }
};

// One lane's payload bytes (zeros past pw words): a 64-bit cache holding
// nb valid bits, left-aligned, refilled from the next word, which was
// read from the staged column one refill earlier.
struct ByteReader {
    Stager<uint32_t> words;
    int next;       // index of the word after q
    u64 cache;
    int nb;
    uint32_t q;

    SQZ_DEVICE void init(const uint32_t* p, int stride, int pw,
                         uint32_t* stage) {
        words.init(p, pw, stride, stage);
        const uint32_t a = words.get(0), b = words.get(1);
        cache = (static_cast<u64>(a) << 32) | b;
        nb = 64;
        q = words.get(2);
        next = 3;
    }

    // the next k (0..4) bytes, right-aligned (the cache holds at least 33
    // bits between calls)
    SQZ_DEVICE u64 take4(int k) {
        const u64 v = k ? cache >> (64 - 8 * k) : 0ull;
        cache = k ? cache << (8 * k) : cache;
        nb -= 8 * k;
        if (nb <= 32) {
            cache |= static_cast<u64>(q) << (32 - nb);
            nb += 32;
            q = words.get(next++);
        }
        return v;
    }

    // the next k (0..8) bytes, big-endian, right-aligned
    SQZ_DEVICE u64 take(int k) {
        const int k1 = k < 4 ? k : 4, k2 = k - k1;
        const u64 hi = take4(k1);
        return (hi << (8 * k2)) | take4(k2);
    }
};

}  // namespace sqz4
