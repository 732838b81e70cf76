// squeeze bitstream packer for Hopper (sm_90a): a tiled scan.
//
// Replaces the TPU kernel sqz_tpu/ops/sqz4_pallas.py:_bitpack_kernel
// (launcher _bitpack_pallas). The native host planner runs each block's
// adaptive-Huffman encode and records its bitstream writes, one u32 a
// write: the bit count in bits 25 and up (0 = a pad record), the value,
// already bit-reversed, in the low 25 bits. This kernel appends every
// lane's values MSB-first at the lane's running bit offset and writes the
// payload as big-endian u32 words in the column layout of the other
// encoders: records uint32 [G, T, B] -> words uint32 [G, cap_words, B]
// (zero past each payload; words past cap_words are dropped, while lens
// still reports the full length) and lens int32 [G, 8, B] (row 0 =
// ceil(bits / 64) * 8, the reference's flush, which pads the final 64-bit
// shift word with zeros).
//
// Domain: a record's bit count is 0 (a pad, a zero record) or 1..25, and
// its value is below 2^count. The planner emits 1..24 bits and pads only
// after a lane's last record; pads anywhere in a column are served too. A
// count above 25 is taken as 25 (it can then not write past the tile's
// words), so it packs differently from the reference.
//
// What bounds it: bytes. The records are read once (~29 MB for 512 blocks
// of 64 KiB of text) and the payload written once; the work per record is
// a few integer operations. The first design walked each lane's column in
// one thread, so a 512-block group had 512 serial walks whose every step
// waited on a load: 2.1 ms, 0.5% of the bound.
//
// The design: a CTA takes a tile of 32 adjacent lanes x kRows record rows.
// Warp w loads the tile's rows [w * kSeg, (w + 1) * kSeg), one coalesced
// 128-byte row a load, so thread l holds lane l's kSeg records of that
// segment in registers. The scan is in two levels: each thread sums its
// segment's bit counts, the eight sums of a lane meet in shared memory,
// and a thread's sum over the earlier segments is its segment's bit
// offset inside the tile. Each thread then packs its segment serially,
// from registers and without a branch, into the lane's words of the tile
// in shared memory, aligned to the tile's first bit (pack_segment): a
// word the segment shares with its neighbours is ORed in, the others
// stored.
//
// The lane's bit offset at the tile comes from a single-pass decoupled
// look-back: each (group, lane, tile) has a 64-bit status word (a flag
// and a bit count: the tile's own bits, or all bits up to and including
// it) in zeroed scratch, published as soon as the segment sums meet.
// Tiles take their index from an atomic ticket, tile-major, so every tile
// a CTA waits on has an earlier ticket and is running or done. A warp
// looks back for four lanes at once, 32 earlier tiles a round trip; a
// lane's status words lie tile after tile, so a window is two 128-byte
// lines.
//
// Then the tile's words, shifted to the lane's offset by a funnel shift,
// go out (store_tile_word): the interior words by plain stores, the first
// and last word of a lane, which a neighbouring tile may share, by a
// global atomic OR into the zero-filled output. No interior store touches
// a word another tile writes. The output is lane-interleaved, so the
// warps go row by row over the rows the 32 lanes' words span, and a store
// of a warp writes the lanes' words of one row, one 128-byte line (a lane
// whose words do not reach the row stores nothing). Storing lane by lane
// instead, a store touches 32 rows: a third slower on random bytes.
//
// The reference's finish() stores `bitcnt ? ah : 0` and then `al`; for
// records of at most 25 bits `al` is 0 there and the zero-filled output
// already holds those words, so the scan needs no store for them. Each
// tile with bits for a lane raises the lane's length by an atomic max to
// that of its inclusive count (the counts only grow), so a lane with no
// records keeps 0. Tiles made only of pad rows publish 0 and end early.
//
// What the card showed (PERF.md): a first tiled design, the tile
// staged in shared memory and each lane's column scanned by a warp 32
// records a step (a shuffle scan, then shared atomic ORs of each record's
// bits), ran 1.4-1.5x longer than this one. In this one a CTA spends
// about half its time loading its tile: the CTAs of a wave load together,
// then compute while device memory idles. A persistent CTA that loads its
// next tile while it packs this one is the next step.

#include <stdint.h>

#include "sqz4_warp.cuh"
#include "sqz_tile.cuh"

namespace squeeze {

constexpr uint32_t kValueMask = 0x1FFFFFFu;
constexpr uint32_t kMaxBits = 25;

// A lane's payload byte length for `bits` bits: the reference's flush.
SQZ_DEVICE int32_t payload_bytes(uint32_t bits) {
    return static_cast<int32_t>(((bits + 63u) >> 6) << 3);
}

// A record's bit count, at most kMaxBits.
SQZ_DEVICE uint32_t record_bits(uint32_t w) {
    return (w >> 25) < kMaxBits ? (w >> 25) : kMaxBits;
}

// Append the N records of one lane's segment (rec) at bit `off` of the
// lane's tile words tw (zeroed; bit 0 the tile's first bit, MSB-first).
// The first word, when the segment starts inside it, and the last, when
// it ends inside it, hold a neighbouring segment's bits too: they are
// ORed in, every other word is stored. The loop body is written without
// branches: a full word is stored under a predicate, the shared first
// one kept aside in a register.
template <int N>
SQZ_DEVICE void pack_segment(const uint32_t (&rec)[N], uint32_t off,
                             uint32_t* tw) {
    const uint32_t w_first = off >> 5;
    const bool shared = (off & 31u) != 0;
    uint32_t wpos = w_first, bitcnt = off & 31u, ah = 0, head = 0;
    SQZ_UNROLL()
    for (int k = 0; k < N; ++k) {
        const uint32_t nb = record_bits(rec[k]);
        const uint64_t x = nb ? static_cast<uint64_t>(rec[k] & kValueMask)
                                    << (64u - bitcnt - nb)
                              : 0u;
        ah |= static_cast<uint32_t>(x >> 32);
        bitcnt += nb;
        const bool full = bitcnt >= 32u;
        const bool aside = full && shared && wpos == w_first;
        if (full && !aside) tw[wpos] = ah;
        head = aside ? ah : head;
        wpos += full;
        ah = full ? static_cast<uint32_t>(x) : ah;
        bitcnt -= full ? 32u : 0u;
    }
    if (head) sqz_tile::atomic_or(tw + w_first, head);
    if (ah) sqz_tile::atomic_or(tw + wpos, ah);
}

// Store word k of a lane's `bits` tile bits (tw, as pack_segment left
// them) at the lane's bit offset `base`: the tile's words go to rows
// base/32 .. (base+bits-1)/32 of the lane's column (out, rows `stride`
// words apart, zero-filled); a k outside them, or a row past cap_words,
// stores nothing. The first and the last word may hold a neighbouring
// tile's bits, so they are ORed in.
SQZ_DEVICE void store_tile_word(const uint32_t* tw, uint32_t base,
                                uint32_t bits, uint32_t k, uint32_t* out,
                                long long stride, uint32_t cap_words) {
    const uint32_t sh = base & 31u, w0 = base >> 5;
    const uint32_t n = bits ? ((base + bits - 1u) >> 5) - w0 + 1u : 0u;
    if (k >= n || w0 + k >= cap_words) return;
    const uint32_t nt = (bits + 31u) >> 5;    // the tile's words
    const uint64_t pair = (static_cast<uint64_t>(k ? tw[k - 1] : 0u) << 32)
                          | (k < nt ? tw[k] : 0u);
    const uint32_t v = static_cast<uint32_t>(pair >> sh);
    uint32_t* dst = out + (w0 + k) * stride;
    if (k == 0 || k == n - 1) {
        if (v) sqz_tile::atomic_or(dst, v);
    } else {
        *dst = v;
    }
}

}  // namespace squeeze

#ifdef __CUDACC__

namespace squeeze {

constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;   // row segments a tile
// lanes of a tile a warp looks back for: w, w + kPackWarps, ...
constexpr int kWarpLanes = sqz_tile::kLanes / kPackWarps;
// status word flags (bits 32 and up; the count in the low 32 bits)
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

template <int kRows>
struct PackSmem {
    // a lane's words in a tile: kRows records of at most kMaxBits bits;
    // an odd pitch spreads the lanes' words over the banks
    static constexpr int kWords = (kRows * kMaxBits + 31) / 32 + 1;
    uint32_t words[sqz_tile::kLanes * kWords];
    uint32_t seg[kPackWarps][sqz_tile::kLanes];   // segment bit counts
    uint32_t bits[sqz_tile::kLanes];              // the lanes' tile bits
    uint32_t base[sqz_tile::kLanes];              // their offsets
    unsigned ticket;
};

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
    return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

// The bits before tile t of the warp's lanes whose bit is set in pending
// (warp-uniform), into sum. st is the status word of the warp's first
// lane at tile t; the words of a lane's tiles are adjacent, its i-th
// lane's lie `step` * i further on. Lane j of the warp reads the words of
// tile hi - j for every pending lane at once (two 128-byte lines a lane),
// so one round trip covers 32 earlier tiles;
// a lane's sum ends at the newest inclusive word, and a window with an
// unpublished word at or after it is read again (it belongs to a running
// CTA that publishes without waiting). Tiles before 0 read as an
// inclusive 0.
__device__ void look_back(const unsigned long long* st, long long step,
                          int t, unsigned pending,
                          uint32_t (&sum)[kWarpLanes]) {
    const int j = threadIdx.x & 31;
    int hi[kWarpLanes];
#pragma unroll
    for (int i = 0; i < kWarpLanes; ++i) hi[i] = t - 1;
    while (pending) {
        unsigned long long s[kWarpLanes];
#pragma unroll
        for (int i = 0; i < kWarpLanes; ++i) {
            const int p = hi[i] - j;
            s[i] = (pending >> i & 1u) && p >= 0
                       ? load_status(st + i * step + (p - t))
                       : kInclusive;
        }
        bool waiting = false;
#pragma unroll
        for (int i = 0; i < kWarpLanes; ++i) {
            if (!(pending >> i & 1u)) continue;
            const unsigned inc = __ballot_sync(~0u, s[i] >= kInclusive);
            const unsigned unready = __ballot_sync(~0u, (s[i] >> 32) == 0);
            const int first = inc ? __ffs(inc) - 1 : 32;
            if (unready & sqz4::below(first + 1)) {
                waiting = true;
                continue;
            }
            sum[i] += __reduce_add_sync(
                ~0u, j <= first ? static_cast<uint32_t>(s[i]) : 0u);
            if (first < 32)
                pending &= ~(1u << i);
            else
                hi[i] -= 32;
        }
        if (waiting) __nanosleep(64);
    }
}

template <int kRows>
__global__ void __launch_bounds__(kPackThreads)
squeeze_bitpack_kernel(const uint32_t* __restrict__ ops, int groups,
                       int rows, int lanes, uint32_t* __restrict__ words,
                       int cap_words, int32_t* __restrict__ lens,
                       unsigned long long* __restrict__ status,
                       unsigned* __restrict__ ticket) {
    constexpr int kSeg = kRows / kPackWarps;
    using Smem = PackSmem<kRows>;
    using sqz_tile::kLanes;
    __shared__ Smem sm;
    const int tid = threadIdx.x, l = tid & 31, warp = tid >> 5;
    if (tid == 0) sm.ticket = atomicAdd(ticket, 1u);
    __syncthreads();
    // tile-major tickets: row tile t of every (group, 32-lane group)
    const int lgs = (lanes + kLanes - 1) / kLanes;
    const int k = static_cast<int>(sm.ticket);
    const int t = k / (groups * lgs), g = k / lgs % groups;
    const int lane0 = k % lgs * kLanes, nl = min(kLanes, lanes - lane0);
    // this thread's segment of lane l: rows r0 + [0, n)
    const int r0 = t * kRows + warp * kSeg;
    const int n = l < nl ? min(kSeg, rows - r0) : 0;
    const uint32_t* src =
        ops + (static_cast<long long>(g) * rows + r0) * lanes + lane0 + l;
    uint32_t rec[kSeg];
#pragma unroll
    for (int i = 0; i < kSeg; ++i)
        rec[i] = i < n ? __ldcs(src + static_cast<long long>(i) * lanes)
                       : 0u;
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < kSeg; ++i) bits += record_bits(rec[i]);
    sm.seg[warp][l] = bits;
    for (int i = tid; i < kLanes * Smem::kWords; i += kPackThreads)
        sm.words[i] = 0u;
    // status words [groups, lanes, tiles]: a lane's tiles adjacent
    const int tiles = (rows + kRows - 1) / kRows;
    unsigned long long* st =
        status + (static_cast<long long>(g) * lanes + lane0 + l) * tiles + t;
    if (!__syncthreads_or(bits != 0)) {   // only pad rows: publish 0, end
        if (warp == 0 && l < nl) store_status(st, t ? kAggregate : kInclusive);
        return;
    }
    uint32_t off = 0, total = 0;
#pragma unroll
    for (int v = 0; v < kPackWarps; ++v) {
        const uint32_t b = sm.seg[v][l];
        off += v < warp ? b : 0u;
        total += b;
    }
    if (warp == 0) {
        if (l < nl) store_status(st, (t ? kAggregate : kInclusive) | total);
        sm.bits[l] = l < nl ? total : 0u;
    }
    if (bits) pack_segment(rec, off, sm.words + l * Smem::kWords);
    __syncthreads();
    // warp w: the offsets, lengths and words of lanes w, w + kPackWarps, ...
    uint32_t base[kWarpLanes] = {};
    unsigned pending = 0;
#pragma unroll
    for (int i = 0; i < kWarpLanes; ++i)
        if (t && sm.bits[warp + i * kPackWarps]) pending |= 1u << i;
    st += static_cast<long long>(warp - l) * tiles;   // lane `warp`'s
    const long long lane_step = static_cast<long long>(kPackWarps) * tiles;
    look_back(st, lane_step, t, pending, base);
#pragma unroll
    for (int i = 0; i < kWarpLanes; ++i) {
        const int c = warp + i * kPackWarps;
        const uint32_t bits_c = sm.bits[c];
        if (l == 0) sm.base[c] = base[i];
        if (!bits_c || l) continue;
        const uint32_t end = base[i] + bits_c;
        if (t) store_status(st + i * lane_step, kInclusive | end);
        atomicMax(lens + static_cast<long long>(g) * 8 * lanes + lane0 + c,
                  payload_bytes(end));
    }
    __syncthreads();
    // row by row over the rows the tile's words span: a store of a warp
    // writes the 32 lanes' words of one row, one 128-byte line
    const uint32_t bits_l = sm.bits[l], base_l = sm.base[l];
    const uint32_t first = bits_l ? base_l >> 5 : ~0u;
    const uint32_t rmin = __reduce_min_sync(~0u, first);
    const uint32_t rmax = __reduce_max_sync(
        ~0u, bits_l ? (base_l + bits_l - 1u) >> 5 : 0u);
    uint32_t* out = words + static_cast<long long>(g) * cap_words * lanes
                    + lane0 + l;
    for (uint32_t r = rmin + warp; r <= rmax; r += kPackWarps)
        store_tile_word(sm.words + l * Smem::kWords, base_l, bits_l,
                        r - first, out, lanes,
                        static_cast<uint32_t>(cap_words));
}

template <int kRows>
int launch(const void* ops, int groups, int rows, int lanes, void* words,
           int cap_words, void* lens, void* scratch, cudaStream_t stream) {
    const int tiles = (rows + kRows - 1) / kRows;
    const int ctas = tiles * groups * ((lanes + 31) / 32);
    if (ctas == 0) return 0;
    auto* sc = static_cast<unsigned long long*>(scratch);
    squeeze_bitpack_kernel<kRows><<<ctas, kPackThreads, 0, stream>>>(
        static_cast<const uint32_t*>(ops), groups, rows, lanes,
        static_cast<uint32_t*>(words), cap_words, static_cast<int32_t*>(lens),
        sc + 1, reinterpret_cast<unsigned*>(sc));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace squeeze

// ops: [groups, rows, lanes] u32; words: [groups, cap_words, lanes] u32,
// zero-filled; lens: [groups, 8, lanes] i32, zero-filled; scratch: 1 +
// groups * ceil(rows / tile_rows) * lanes zeroed u64 (the ticket, then the
// status words). tile_rows is 128 or 256. Launches on `stream`; returns
// the cudaError_t of the launch.
extern "C" int squeeze_bitpack_launch(const void* ops, int groups, int rows,
                                      int lanes, void* words, int cap_words,
                                      void* lens, void* scratch,
                                      int tile_rows, void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (tile_rows == 256)
        return squeeze::launch<256>(ops, groups, rows, lanes, words,
                                    cap_words, lens, scratch, s);
    if (tile_rows == 128)
        return squeeze::launch<128>(ops, groups, rows, lanes, words,
                                    cap_words, lens, scratch, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

#endif  // __CUDACC__
