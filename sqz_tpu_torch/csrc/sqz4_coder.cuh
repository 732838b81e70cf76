// Shared pieces of the sqz4 range-coder kernels (FORMAT.md §2.2-§2.3).
//
// One thread codes one block. Its coder registers are native 64-bit
// integers, and its adaptive models live in shared memory:
//   - the 256-symbol byte and size models as per-symbol counts plus a
//     Fenwick tree of cumulative counts, so a symbol's statistics, the
//     symbol holding a cumulative count, and the update after coding each
//     take O(log 256) accesses (a plain cumulative table needs up to 256
//     updates per coded symbol);
//   - the 32-symbol bits model as an inclusive cumulative table;
//   - the binary literal-flag and distance-bit models as two counts each.
// The integer values are those of the reference models, so every
// statistic, and with it every coded byte, is the same.
//
// Table entry e of a thread sits at tab[e * stride], where stride is the
// CTA's thread count, so a warp's threads never conflict on a bank.
//
// The encoder's coder step (Encoder::code) is shared by the model-driven
// encoder kernels: the op-stream encoder reads the ops, the token encoder
// expands them from tokens, and both code them through the same
// arithmetic (Encoder::code_stats), which the stats-fed encoder calls on
// statistics computed on the host.
//
// The lane bodies are plain C++ apart from __clzll and the SQZ_DEVICE
// qualifier; the kernels and launchers sit under __CUDACC__.
#pragma once

#include <stdint.h>

#ifndef SQZ_DEVICE
#define SQZ_DEVICE __device__ __forceinline__
#endif

namespace sqz4 {

typedef unsigned long long u64;

// per-thread table layout (int32 entries)
constexpr int kByteFreq = 0;      // byte model counts [256]
constexpr int kByteTree = 256;    // byte model Fenwick tree [257], 1-based
constexpr int kSizeFreq = 513;    // size model counts [256]
constexpr int kSizeTree = 769;    // size model Fenwick tree [257], 1-based
constexpr int kBits = 1026;       // bits model inclusive csum [32]
constexpr int kDist0 = 1058;      // distance-bit models, count of 0 [32]
constexpr int kDist1 = 1090;      // distance-bit models, count of 1 [32]
constexpr int kLit = 1122;        // literal-flag model, counts of 0, 1 [2]
constexpr int kTableWords = 1124;

// micro-op codes of the encoder's input stream (sqz4_pallas.py:576-577)
constexpr int kOpFlag = 0, kOpSize = 1, kOpByte = 2, kOpBits = 3;
constexpr int kOpDist = 4;   // 4..35: distance bit 0..31
constexpr int kOpFlush = 254;

// decoder states and error codes (sqz4_pallas.py:1647-1648)
constexpr int kFlag = 0, kBitsState = 3, kDistState = 4, kDone = 5,
              kErr = 6;
constexpr int kEIlseq = 1, kESize = 2, kEBits = 3, kEDist = 4,
              kEOverrun = 5;

// Number of leading zero bytes of x (8 for x == 0): the count of equal
// leading bytes of low and low + range, i.e. the renormalization shift.
SQZ_DEVICE int lead_zero_bytes(u64 x) {
    return x ? (__clzll(static_cast<long long>(x)) >> 3) : 8;
}

SQZ_DEVICE u64 shl(u64 x, int s) { return s >= 64 ? 0ull : x << s; }

// A 256-symbol model: counts f[0..255], Fenwick tree t[1..256] (t[i]
// sums the counts of symbols i - lowbit(i) .. i - 1; t[256] is the total).
struct Model256 {
    int* f;
    int* t;
    int stride;

    SQZ_DEVICE int total() const { return t[256 * stride]; }

    // sum of the counts of symbols below s
    SQZ_DEVICE int start(int s) const {
        int acc = 0;
        for (int i = s; i > 0; i -= i & -i) acc += t[i * stride];
        return acc;
    }

    SQZ_DEVICE int size(int s) const { return f[s * stride]; }

    // the symbol whose [start, start + size) holds cum (cum < total)
    SQZ_DEVICE int search(int cum, int* start) const {
        int pos = 0, rem = cum;
        for (int k = 128; k > 0; k >>= 1) {
            const int v = t[(pos + k) * stride];
            if (v <= rem) {
                pos += k;
                rem -= v;
            }
        }
        *start = cum - rem;
        return pos;
    }

    SQZ_DEVICE void bump(int s) {
        f[s * stride] += 1;
        for (int i = s + 1; i <= 256; i += i & -i) t[i * stride] += 1;
    }
};

SQZ_DEVICE Model256 model256(int* tab, int stride, bool byte) {
    return Model256{tab + (byte ? kByteFreq : kSizeFreq) * stride,
                    tab + (byte ? kByteTree : kSizeTree) * stride, stride};
}

SQZ_DEVICE void init_tables(int* tab, int stride) {
    for (int i = 0; i < 256; ++i) {
        tab[(kByteFreq + i) * stride] = 1;
        tab[(kSizeFreq + i) * stride] = 1;
    }
    for (int i = 1; i <= 256; ++i) {   // every count 1: t[i] = lowbit(i)
        tab[(kByteTree + i) * stride] = i & -i;
        tab[(kSizeTree + i) * stride] = i & -i;
    }
    for (int i = 0; i < 32; ++i) {
        tab[(kBits + i) * stride] = i + 1;
        tab[(kDist0 + i) * stride] = 1;
        tab[(kDist1 + i) * stride] = 1;
    }
    tab[kLit * stride] = 1;
    tab[(kLit + 1) * stride] = 1;
}

// +1 on csum entries [from, n): the adaptive update of symbol `from`.
SQZ_DEVICE void csum_bump(int* c, int stride, int from, int n) {
    for (int i = from; i < n; ++i) c[i * stride] += 1;
}

// Statistics of symbol s in an inclusive csum table of n entries.
SQZ_DEVICE void csum_stats(const int* c, int stride, int n, int s,
                           int* start, int* size, int* total) {
    *start = s ? c[(s - 1) * stride] : 0;
    *size = c[s * stride] - *start;
    *total = c[(n - 1) * stride];
}

// Symbol whose [start, start + size) holds cum: the number of entries
// <= cum (csum entries are strictly increasing; cum < total). n is a
// power of two.
SQZ_DEVICE int csum_search(const int* c, int stride, int n, int cum) {
    int sym = 0;
    for (int step = n >> 1; step > 0; step >>= 1)
        if (c[(sym + step - 1) * stride] <= cum) sym += step;
    return sym;
}

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

// One block's range encoder: its coder registers, its models (in `tab`)
// and its output sink. code() takes one micro-op (sqz4_pallas.py
// _fused_pair_body, one slot): 0 flag, 1 size, 2 byte, 3 bits, 4..35
// distance bit, 254 flush; anything else is a pad and codes nothing. It
// looks the symbol up in its model, updates the model, and codes the
// statistics with code_stats(), which the stats-fed encoder
// (sqz4_encode_stats.cu) calls directly on host-computed statistics; that
// encoder needs no tables (tab may be null).
struct Encoder {
    int* tab;
    int stride;
    u64 low;
    u64 rng;
    WordSink sink;

    // exactly one emission of the top byte
    SQZ_DEVICE void flush() {
        sink.put(static_cast<uint32_t>(low >> 56));
        low <<= 8;
    }

    // Narrow the interval to [start, start + size) of total, renormalize
    // (with the underflow escape) and emit the settled bytes.
    SQZ_DEVICE void code_stats(u64 start, u64 size, u64 total) {
        const u64 q = rng / total;
        low += start * q;
        rng = size * q;
        const u64 pre = low;
        int cnt = lead_zero_bytes(low ^ (low + rng));
        low = shl(low, 8 * cnt);
        rng = shl(rng, 8 * cnt);
        if (rng < total + 1) {
            // underflow escape: two more emissions, re-inflate the range
            low = shl(pre, 8 * cnt + 16);
            rng = ~low;
            cnt += 2;
        }
        for (int k = 0; k < cnt; ++k)
            sink.put(k < 8 ? static_cast<uint32_t>(pre >> (56 - 8 * k)) & 0xFF
                           : 0u);
    }

    SQZ_DEVICE void code(int m, int s) {
        if (m == kOpFlush) {
            flush();
            return;
        }
        if (m >= kOpDist + 32) return;   // pad

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
        code_stats(static_cast<u64>(start), static_cast<u64>(size),
                   static_cast<u64>(total));
    }

    // Write the last partial word; returns the payload byte length (which
    // may exceed the column's capacity: bytes past it are dropped).
    SQZ_DEVICE int32_t finish() {
        sink.finish();
        return static_cast<int32_t>(sink.n);
    }
};

// A fresh (cold) encoder writing into one lane's output column, whose rows
// are `lanes` elements apart and must be zero-filled by the caller.
SQZ_DEVICE Encoder make_encoder(uint32_t* words, int lanes, int cap_words,
                                int* tab, int stride) {
    if (tab) init_tables(tab, stride);
    return Encoder{tab, stride, 0ull, ~0ull,
                   WordSink{words, lanes, cap_words, 0u, 0}};
}

}  // namespace sqz4
