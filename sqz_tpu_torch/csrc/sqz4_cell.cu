// The resident restore's cell assembly for Hopper (sm_90a).
//
// Replaces the compiled scans of the reference's cell restore,
// sqz_tpu/ops/resident.py:decode_rle_group (_classify_cells and
// _fill_cells, two jax.lax.scan over the cells, with the one-hot gathers
// around them); it is not the port of a Pallas kernel. It takes the
// decoder's outputs of one group as the decoder writes them (lane-minor:
// lane b's row r at r * B + b): the dense literal stream lit [lw, B], the
// token bits tok [tw, B] (one bit a decoded token, set for a match), the
// match records mrec [mw, B] (len << 16 | dist, in match order) and the
// counts [8, B] (ntok row 2, err row 4, ovf row 6), with the block sizes
// [B]; it writes the blocks [B, C * 128] u8 and a bad flag a lane for
// streams that are not cell-parsed (their lanes go to another route).
//
// What it computes, for each lane, as the plain version
// (sqz_tpu_torch/ops/resident.py:assemble_cells_ref) does:
//   the walk: a cell is a match cell iff the token at the walk's cursor
//     is a match; the cursor moves one token on a match and one a byte on
//     a literal cell. Reads past the staged rows give 0, as the
//     reference's one-hot reads do. The lane is bad when the walk did not
//     consume exactly ntok tokens, or the decoder flagged it;
//   the fill: a match must be a len-128 match at a power-of-2 dist <= 128
//     (a periodic cell) or at a cell-aligned dist within the block (a far
//     copy), in a full cell, else the lane is bad. A literal cell takes
//     the next cell of the literal stream, a periodic cell the previous
//     output cell's tail (prev[128 - d + j % d]), a far copy the literal
//     bytes of its source cell (zeros if the source is not a literal
//     cell), any other cell zeros; bytes past the block's size are
//     written as zeros;
//   the far-copy check: the reference compares each far copy with its
//     source's output after assembly. A far copy is its source's literal
//     bytes when the source is a literal cell, equal by construction;
//     otherwise it is zeros, so the check is that the source's output is
//     all zeros (a bit a cell says whether it came out nonzero).
//
// What bounds it: bytes (every literal read once, every block byte
// written once, the token and record columns read once: about 56 MB at
// 512 x 64 KiB of the resident mix, 0.017 ms at 3.35 TB/s). The first
// design (a CTA a lane) was bound by latency instead: a one-thread walk
// of a shared-memory read a cell, then a barrier a cell. This one:
// - a CTA is a tile of kTile adjacent lanes, a warp a lane. The CTA
//   stages the tile's token and record columns, and its literal rows in
//   chunks of kChunk literal cells, as whole row segments (kTile adjacent
//   words of a row, 4-byte cp.async, kPitch = kTile + 1 words a staged
//   row so that a warp reading one lane's 32 rows hits 32 banks);
// - the walk is a scan of the token bits, 32 words a step: in a
//   cell-parsed stream a one-bit with ob ones and zb zeros before it is
//   match cell ob + zb / 128 when zb % 128 == 0, and the cells no match
//   claims are literal cells in order. From the first one-bit off a cell
//   start the walk goes on a run a step (walk_runs: the set bits from the
//   cursor are k match cells, then a ballot over the bits at tcur + 128 i
//   gives up to 32 literal cells), as the sequential walk would;
// - the literal cells go first, a transposed copy: the tile's literal
//   rows stream through kBufs chunk buffers (kChunk literal cells a lane,
//   kBufs - 1 in flight), and round k writes each lane's literal cells
//   [k * kChunk, (k + 1) * kChunk) to their cells, one CTA barrier a
//   round; the rounds are even across the lanes;
// - then each warp writes its lane's other cells, 32 cells a step with
//   no barrier, a lane a cell for the control: its record, the cell its
//   bytes come from (the source of a far copy of a literal cell) and, for
//   a periodic cell, its base. Periodic fills compose, f_e(f_d(p)) =
//   f_min(d,e)(p) (d, e powers of two dividing 128), so a periodic cell
//   is the last non-periodic cell before it (its base) at the least
//   period since: a ballot a period over the lanes, no chain from cell to
//   cell. The step's cells are then written 16 bytes a lane, 8 lanes a
//   cell, read from the literal cells already in the lane's output row.
//   A warp whose literal cells are all written takes its steps inside the
//   tile's remaining rounds, between their barriers.
//
// What a host compiler sees: the tile body as plain C++ on the warp
// primitives of sqz4_warp.cuh (one lane a warp, or a warp of 32 host
// threads under SQZ_HOST_WARP); cta_sync is a no-op for a CTA of one
// thread, and a host includer that defines SQZ_HOST_CTA supplies it for
// a CTA of host threads (tests/test_torch_csrc_host.py). The staging is
// a plain copy there; the kernel and its launcher are device code.

#include <stdint.h>
#include <string.h>

#include "sqz4_warp.cuh"

#ifdef __CUDACC__
#define SQZ_CELL_HD __host__ __device__ __forceinline__
#else
#define SQZ_CELL_HD inline
#endif

// the phase stamps of scripts/cell_timeline.py (empty in the package)
#ifndef SQZ_CELL_STAMP
#define SQZ_CELL_STAMP(i)
#endif

namespace sqz4_cell {

using sqz4::kLanes;

constexpr int kCell = 128;
constexpr int kCellWords = kCell / 4;
// the words of a cell a lane holds
constexpr int kPer = kCellWords / kLanes;
static_assert(kLanes == 1 || kLanes == kCellWords, "a warp holds a cell");
// a cell's code from the walk: its kind in the top two bits, and below
// them its literal cell or its match record
constexpr uint32_t kKind = 3u << 30;
constexpr uint32_t kZero = 0u;
constexpr uint32_t kLit = 1u << 30;
constexpr uint32_t kMatch = 2u << 30;
constexpr uint32_t kValue = ~kKind;
// cells a lane at most (a match step packs a cell in 10 bits)
constexpr int kMaxCells = 1 << 9;

// the kernel's geometry: lanes a CTA, literal cells a chunk, chunk
// buffers, literal cells a lane writes a batch
#ifndef SQZ_CELL_TILE
#define SQZ_CELL_TILE 4
#endif
#ifndef SQZ_CELL_CHUNK
#define SQZ_CELL_CHUNK 32
#endif
#ifndef SQZ_CELL_BUFS
#define SQZ_CELL_BUFS 3
#endif
constexpr int kTileLanes = SQZ_CELL_TILE;
constexpr int kTileChunk = SQZ_CELL_CHUNK;
constexpr int kTileBufs = SQZ_CELL_BUFS;
constexpr int kBatch = 8;

#ifdef __CUDACC__
SQZ_DEVICE void cta_sync() { __syncthreads(); }
SQZ_DEVICE int ctz32(uint32_t x) { return __ffs(static_cast<int>(x)) - 1; }
// *dst = *src for one word, copied asynchronously into shared memory
SQZ_DEVICE void stage_word(uint32_t* dst, const uint32_t* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
                 "l"(src)
                 : "memory");
}
SQZ_DEVICE void stage_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most kPending of this thread's latest groups are in flight
template <int kPending>
SQZ_DEVICE void stage_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}
// a word of an input no thread writes
SQZ_DEVICE uint32_t load_input(const uint32_t* p) { return __ldg(p); }
SQZ_DEVICE void store_word(uint8_t* p, uint32_t x) {
    *reinterpret_cast<uint32_t*>(p) = x;
}
// 16 aligned bytes as 4 words, and back
SQZ_DEVICE void load16(const uint8_t* p, uint32_t* w) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
}
SQZ_DEVICE void store16(uint8_t* p, const uint32_t* w) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
#else
#ifndef SQZ_HOST_CTA   // else the includer defines it
SQZ_DEVICE void cta_sync() {}
#endif
SQZ_DEVICE int ctz32(uint32_t x) { return __builtin_ctz(x); }
SQZ_DEVICE void stage_word(uint32_t* dst, const uint32_t* src) {
    *dst = *src;
}
SQZ_DEVICE void stage_commit() {}
template <int kPending>
SQZ_DEVICE void stage_wait() {}
SQZ_DEVICE uint32_t load_input(const uint32_t* p) { return *p; }
SQZ_DEVICE void store_word(uint8_t* p, uint32_t x) { memcpy(p, &x, 4); }
SQZ_DEVICE void load16(const uint8_t* p, uint32_t* w) { memcpy(w, p, 16); }
SQZ_DEVICE void store16(uint8_t* p, const uint32_t* w) { memcpy(p, w, 16); }
#endif

// Shared memory of a tile (32-bit words), in this order: the token and
// record columns and the chunk buffers (kPitch words a row), then a
// lane's cell codes, the cell of each of its literal cells, its nonzero
// bits, its literal count and a scratch of 32 words.
template <int kTile, int kChunk, int kBufs>
struct Layout {
    static constexpr int kPitch = kTile + 1;
    static constexpr int kChunkRows = kChunk * kCellWords;
    int tw, nm, C, nzw;
    SQZ_CELL_HD Layout(int tw_, int mw, int C_)
        : tw(tw_), nm(mw < C_ ? mw : C_), C(C_), nzw((C_ + 31) / 32) {}
    SQZ_CELL_HD int rec() const { return tw * kPitch; }
    SQZ_CELL_HD int bufs() const { return rec() + nm * kPitch; }
    SQZ_CELL_HD int lanes() const {
        return bufs() + kBufs * kChunkRows * kPitch;
    }
    SQZ_CELL_HD int lane_words() const { return 2 * C + nzw + 1 + 32; }
    SQZ_CELL_HD int words() const { return lanes() + kTile * lane_words(); }
};

// Copy rows [0, rows) of the tile's nl lanes of a [rows, B] column (src
// at lane 0 of the tile's row 0) to dst, kTile + 1 words a row:
// consecutive threads take consecutive words of a row, so a warp's copies
// cover whole row segments, and a thread keeps its lane (rows: the rows
// this thread's lane takes).
template <int kTile, int kThreads>
SQZ_DEVICE void stage_rows(int tid, const uint32_t* src, long long B,
                           int rows, int nl, uint32_t* dst) {
    static_assert(kThreads % kTile == 0, "a thread keeps its lane");
    constexpr int kStep = kThreads / kTile;
    const int l = tid % kTile, r0 = tid / kTile;
    if (l >= nl) return;
    const uint32_t* from = src + r0 * B + l;
    uint32_t* to = dst + r0 * (kTile + 1) + l;
    for (int r = r0; r < rows; r += kStep) {
        stage_word(to, from);
        from += kStep * B;
        to += kStep * (kTile + 1);
    }
}

// The walk's cell codes from cell c on, one step a run: from cursor tcur
// (nm match cells and nlit literal cells before c), a run of set token
// bits is k match cells (the trailing ones of a 32-bit window), then a run
// of literal cells (a ballot over the bits at tcur + 128 i, lane i testing
// cell c + i). Writes the codes of cells [c, nc) and each literal cell's
// cell to litcell[]; returns the tokens consumed. Warp-uniform.
template <int kPitch>
SQZ_DEVICE int walk_runs(const uint32_t* tok, int tw, int size, int nc,
                         int c, int tcur, int nm, int* nlit_io,
                         uint32_t* cell, int32_t* litcell) {
    const int lane = sqz4::lane_id();
    int nlit = *nlit_io;
    while (c < nc) {
        const int sh = tcur & 31, wi = tcur >> 5;
        const uint32_t lo = wi < tw ? tok[wi * kPitch] : 0u;
        const uint32_t hi = wi + 1 < tw ? tok[(wi + 1) * kPitch] : 0u;
        const uint32_t win = sh ? (lo >> sh) | (hi << (32 - sh)) : lo;
        int k = win == ~0u ? 32 : ctz32(~win);
        if (k > nc - c) k = nc - c;
        for (int i = lane; i < k; i += kLanes)
            cell[c + i] = kMatch | static_cast<uint32_t>(nm + i);
        c += k;
        tcur += k;
        nm += k;
        if (k == 32 || c >= nc) continue;
        // the bit at the cursor is clear: literal cells, the cells before
        // cell c + i full literal ones
        const int t = tcur + kCell * lane;
        const int tw_i = t >> 5;
        const bool stop = c + lane >= nc
            || (lane > 0 && tw_i < tw
                && ((tok[tw_i * kPitch] >> (t & 31)) & 1u));
        const int m = sqz4::lowest(sqz4::ballot(stop));
        if (lane < m) {
            cell[c + lane] = kLit | static_cast<uint32_t>(nlit + lane);
            litcell[nlit + lane] = c + lane;
        }
        const int rem = size - (c + m - 1) * kCell;
        tcur += kCell * (m - 1) + (rem < kCell ? rem : kCell);
        nlit += m;
        c += m;
    }
    *nlit_io = nlit;
    return tcur;
}

// The sum of v over the lanes below this one (v < 256): a ballot a bit
SQZ_DEVICE int lanes_below_sum(int v) {
    int s = 0;
    for (int bit = 0; bit < 8; ++bit)
        s += sqz4::popc(sqz4::ballot((v >> bit) & 1)
                        & sqz4::below(sqz4::lane_id())) << bit;
    return s;
}

// token words a lane takes a step of the walk's scan
constexpr int kScanWords = 4;

// The walk of a lane of `size` bytes and C cells through its staged token
// bits (tok, tw rows kPitch words apart): each cell's code to cell[],
// each literal cell's cell to litcell[], the literal cells to *nlit;
// returns the tokens consumed. Warp-uniform.
//
// In a cell-parsed stream every one-bit is a match cell's token and the
// zeros between them come 128 a literal cell, so a one-bit at p with ob
// ones before it is match cell ob + (p - ob) / 128, match record ob, when
// (p - ob) % 128 == 0. The walk takes that from a scan of the bits
// (kScanWords words a lane a step), up to the first one-bit off a cell
// start (the walk's cursor passes over it inside a literal cell:
// walk_runs goes on from that cell); the cells no match claims are
// literal cells, in order. Reads past the staged rows give 0.
template <int kPitch>
SQZ_DEVICE int walk(const uint32_t* tok, int tw, int size, int C,
                    uint32_t* cell, int32_t* litcell, int* nlit_out) {
    const int lane = sqz4::lane_id();
    const int nc = size <= 0 ? 0 : (size + kCell - 1) / kCell < C
                                        ? (size + kCell - 1) / kCell : C;
    for (int i = lane; i < C; i += kLanes) cell[i] = kZero;
    sqz4::warp_sync();
    int ones = 0;                       // one-bits before word w0
    int cstop = nc, sstop = 0, mstop = 0;
    bool stopped = false;
    for (int w0 = 0; w0 < tw && !stopped; w0 += kLanes * kScanWords) {
        // the next bit's cell: ones + zeros / 128
        if (ones + (32 * w0 - ones) / kCell >= nc) break;
        uint32_t word[kScanWords];
        int pc = 0;
        for (int j = 0; j < kScanWords; ++j) {
            const int w = w0 + lane * kScanWords + j;
            word[j] = w < tw ? tok[w * kPitch] : 0u;
            pc += sqz4::popc(word[j]);
        }
        if (sqz4::ballot(pc != 0) == 0) continue;
        int ob = ones + lanes_below_sum(pc);
        int irr_cell = -1, irr_start = 0, irr_ob = 0;
        for (int j = 0; j < kScanWords && irr_cell < 0; ++j) {
            const int w = w0 + lane * kScanWords + j;
            for (uint32_t bits = word[j]; bits; bits &= bits - 1, ++ob) {
                const int p = 32 * w + ctz32(bits);
                const int zb = p - ob, off = zb % kCell;
                const int cc = ob + zb / kCell;
                if (cc >= nc) break;
                if (off) {
                    irr_cell = cc;
                    irr_start = p - off;
                    irr_ob = ob;
                    break;
                }
                cell[cc] = kMatch | static_cast<uint32_t>(ob);
            }
        }
        const unsigned irr = sqz4::ballot(irr_cell >= 0);
        if (irr) {
            const int l = sqz4::lowest(irr);
            cstop = sqz4::shfl(irr_cell, l);
            sstop = sqz4::shfl(irr_start, l);
            mstop = sqz4::shfl(irr_ob, l);
            stopped = true;
        }
        ones += sqz4::warp_sum(pc);
    }
    sqz4::warp_sync();
    // the cells before cstop that no match claims: literal cells in order
    int nm = 0;
    for (int c0 = 0; c0 < cstop; c0 += kLanes) {
        const int c = c0 + lane;
        const bool ism = c < cstop && (cell[c] & kKind) == kMatch;
        const unsigned mm = sqz4::ballot(ism);
        if (c < cstop && !ism) {
            const int li = c - nm - sqz4::popc(mm & sqz4::below(lane));
            cell[c] = kLit | static_cast<uint32_t>(li);
            litcell[li] = c;
        }
        nm += sqz4::popc(mm);
    }
    int nlit = cstop - nm;
    int tcur;
    if (stopped) {
        tcur = walk_runs<kPitch>(tok, tw, size, nc, cstop, sstop, mstop,
                                 &nlit, cell, litcell);
    } else if (nc == 0) {
        tcur = 0;
    } else {
        // after the last cell: its first token, then one token or its
        // bytes
        sqz4::warp_sync();
        const int last = nc - 1;
        const uint32_t x = cell[last];
        const int mb = (x & kKind) == kMatch ? static_cast<int>(x & kValue)
                                             : nm;
        const int rem = size - last * kCell;
        tcur = mb + kCell * (last - mb)
             + ((x & kKind) == kMatch ? 1 : rem < kCell ? rem : kCell);
    }
    *nlit_out = nlit;
    return tcur;
}

// This lane's word w of cell c of out, masked past size (big-endian
// words, as the literal stream holds them).
SQZ_DEVICE void put_word(uint8_t* out, int c, int w, int size, uint32_t v) {
    const int pos = c * kCell + 4 * w;
    const int n = size - pos;
    const uint32_t keep = n >= 4 ? ~0u : n <= 0 ? 0u : ~0u << (8 * (4 - n));
    store_word(out + pos, sqz4::bswap32(v & keep));
}

// The literal cells [lo, hi) of a lane from its chunk buf (its literal
// cells from lo, kPitch words a row) to their cells of out, kBatch at a
// time; only the lane's last cell (nc - 1) can be short.
template <int kPitch>
SQZ_DEVICE void put_literals(int lo, int hi, const uint32_t* buf,
                             const int32_t* litcell, int nc, int size,
                             uint8_t* out) {
    const int lane = sqz4::lane_id();
    for (int l0 = lo; l0 < hi; l0 += kBatch) {
        int c[kBatch];
        uint32_t v[kBatch][kPer];
        SQZ_UNROLL()
        for (int u = 0; u < kBatch; ++u)
            c[u] = l0 + u < hi ? litcell[l0 + u] : -1;
        SQZ_UNROLL()
        for (int u = 0; u < kBatch; ++u)
            for (int p = 0; p < kPer; ++p)
                v[u][p] = c[u] < 0 ? 0u
                    : buf[((l0 + u - lo) * kCellWords + lane + p * kLanes)
                          * kPitch];
        SQZ_UNROLL()
        for (int u = 0; u < kBatch; ++u)
            for (int p = 0; p < kPer; ++p) {
                if (c[u] == nc - 1)
                    put_word(out, c[u], lane + p * kLanes, size, v[u][p]);
                else if (c[u] >= 0)
                    store_word(out + c[u] * kCell + 4 * (lane + p * kLanes),
                               sqz4::bswap32(v[u][p]));
            }
    }
}

// a match record's dist, and whether it makes a periodic cell
SQZ_DEVICE bool periodic(uint32_t x, uint32_t r) {
    const uint32_t d = r & 0xFFFFu;
    return (x & kKind) == kMatch && d - 1u < static_cast<uint32_t>(kCell)
           && (d & (d - 1)) == 0;
}

// the highest set bit of x, -1 for none
SQZ_DEVICE int high_bit(uint32_t x) {
#ifdef __CUDACC__
    return 31 - __clz(static_cast<int>(x));
#else
    return x ? 31 - __builtin_clz(x) : -1;
#endif
}

// the OR of x over the lanes
SQZ_DEVICE uint32_t lanes_or(uint32_t x) {
#ifdef __CUDACC__
    return __reduce_or_sync(0xffffffffu, x);
#else
    for (int off = 1; off < kLanes; off <<= 1)
        x |= static_cast<uint32_t>(sqz4::shfl(static_cast<int>(x),
                                              sqz4::lane_id() ^ off));
    return x;
#endif
}

// 16-byte parts of a cell, and the parts a lane writes a step of
// match step (all of a step's cells on a warp)
constexpr int kParts = kCell / 16;
constexpr int kPutItems = kCell / 16;

// A match step's control: kLanes cells from g0, a lane a cell.
// A cell to write (not literal) is packed as its cell, the cell its
// bytes come from (ws, the last 10 bits all ones for none) and log2 of its
// period.
struct Control {
    uint32_t todo;      // the lanes whose cell is written
    uint32_t item;      // this lane's cell, packed
};

SQZ_DEVICE Control control(int g0, int C, const uint32_t* cell,
                           const uint32_t* rec, int kpitch, int nm, int size,
                           int* carry_ws, int* carry_lm, bool* bad) {
    const int lane = sqz4::lane_id();
    const int c = g0 + lane;
    const bool in = c < C;
    const uint32_t x = in ? cell[c] : kZero;
    const uint32_t i = x & kValue;
    const bool match = (x & kKind) == kMatch;
    const uint32_t r = match && i < static_cast<uint32_t>(nm)
                     ? rec[i * kpitch] : 0u;
    const uint32_t d = r & 0xFFFFu;
    const bool okd = periodic(x, r);
    const bool okfar = match && d > kCell && d % kCell == 0
                       && d <= static_cast<uint32_t>(c) * kCell;
    *bad = *bad || (in && match && ((r >> 16) != kCell || !(okd || okfar)
                                    || size - c * kCell < kCell));
    int ws = (x & kKind) == kLit ? c : -1;
    if (match && d > kCell) {
        int src = c - static_cast<int>(d / kCell);
        src = src > 0 ? src : 0;
        ws = (cell[src] & kKind) == kLit ? src : -1;
    }
    // the last cell at or before this one that is not periodic, and the
    // least period of the periodic cells after it (a ballot a period)
    const int head = high_bit(sqz4::ballot(!okd) & sqz4::below(lane + 1));
    const uint32_t since = sqz4::below(lane + 1) & ~sqz4::below(head + 1);
    int lm = 7;
    for (int k = 7; k >= 0; --k)
        lm = sqz4::ballot(okd && d == (1u << k)) & since ? k : lm;
    const int hws = sqz4::shfl(ws, head > 0 ? head : 0);
    if (head < 0) lm = *carry_lm < lm ? *carry_lm : lm;
    ws = okd ? (head < 0 ? *carry_ws : hws) : ws;
    *carry_ws = sqz4::shfl(ws, kLanes - 1);
    *carry_lm = sqz4::shfl(lm, kLanes - 1);
    Control ctl;
    ctl.todo = sqz4::ballot(in && (x & kKind) != kLit);
    ctl.item = static_cast<uint32_t>(c) << 16
             | (static_cast<uint32_t>(ws) & 0x3FFu) << 3
             | static_cast<uint32_t>(lm);
    return ctl;
}

// Part t (words 4t..4t+3) of a packed cell's bytes into v (little-endian
// words, as out holds them): the bytes of cell ws of out (zeros for none)
// filled at period 2^lm. A periodic fill reads prev[128 - m + j % m]
// (m = 128 is the cell itself): one 16-byte read, the words from
// 32 - m / 4 for m >= 16, the last four below.
SQZ_DEVICE void part_words(const uint8_t* out, uint32_t item, int t,
                           uint32_t* v) {
    const int ws = static_cast<int>((item >> 3) & 0x3FFu);
    const int lm = static_cast<int>(item & 7u);
    if (ws == 0x3FF) {
        v[0] = v[1] = v[2] = v[3] = 0u;
        return;
    }
    const int q = lm >= 2 ? 1 << (lm - 2) : 1;
    uint32_t y[4];
    load16(out + ws * kCell
               + 4 * (lm >= 4 ? kCellWords - q + ((4 * t) & (q - 1)) : 28),
           y);
    for (int i = 0; i < 4; ++i) {
        const uint32_t z = y[lm >= 4 ? i : lm == 3 ? 2 + (i & 1) : 3];
        v[i] = lm == 0 ? (z >> 24) * 0x01010101u
             : lm == 1 ? (z >> 16) * 0x00010001u : z;
    }
}

// The cells of a lane that are not literal, after its literal cells are
// in out, a step at a time (the tile body runs steps while other lanes'
// literal rounds go on); then the far-copy check. A step takes kLanes
// cells, a lane a cell (control): its record, the cell its bytes come
// from (itself for a literal cell, the source of a far copy of a literal
// cell, none for zeros) and, for a periodic cell, its base: the last cell
// before it that is not periodic. Periodic fills compose (f_e(f_d(p)) =
// f_min(d,e)(p), d and e powers of two dividing 128), so a periodic cell
// is the base's bytes at the least period since. Then the step's cells
// that are not literal are written, 16 bytes a lane, 8 lanes a cell, read
// from the literal cells already in out; the next step's control runs
// while those reads are in flight.
struct Matches {
    const uint32_t* cell;
    const uint32_t* rec;
    int kpitch, nm, C, nc, size;
    uint8_t* out;
    uint32_t* nz;
    uint32_t* scratch;      // kLanes words
    Control ctl;            // the next step's
    int g0;                 // its first cell
    int carry_ws, carry_lm;
    bool bad;               // by the records

    SQZ_DEVICE void begin() {
        g0 = 0;
        carry_ws = -1;
        carry_lm = 7;
        bad = false;
        ctl = control(0, C, cell, rec, kpitch, nm, size, &carry_ws,
                      &carry_lm, &bad);
    }

    SQZ_DEVICE bool done() const { return g0 >= C; }

    SQZ_DEVICE void step() {
        const int lane = sqz4::lane_id();
        const Control now = ctl;
        uint32_t v[kPutItems][4], at[kPutItems];
        const int items = sqz4::popc(now.todo) * kParts;
        if (items) {
            // the step's cells to write, in order, to scratch
            sqz4::warp_sync();
            if ((now.todo >> lane) & 1u)
                scratch[sqz4::popc(now.todo & sqz4::below(lane))] = now.item;
            sqz4::warp_sync();
            SQZ_UNROLL()
            for (int u = 0; u < kPutItems; ++u) {
                const int e = u * kLanes + lane;
                at[u] = e < items ? scratch[e / kParts] : ~0u;
                part_words(out, e < items ? at[u] : 0x3FFu << 3, e % kParts,
                           v[u]);
            }
        }
        if (g0 + kLanes < C)
            ctl = control(g0 + kLanes, C, cell, rec, kpitch, nm, size,
                          &carry_ws, &carry_lm, &bad);
        uint32_t nzacc = 0;
        if (items) {
            SQZ_UNROLL()
            for (int u = 0; u < kPutItems; ++u) {
                if (at[u] == ~0u) continue;
                const int c = static_cast<int>(at[u] >> 16);
                const int pos = c * kCell
                              + 16 * ((u * kLanes + lane) % kParts);
                if (c == nc - 1)        // the last cell can be short
                    for (int i = 0; i < 4; ++i) {
                        const int n = size - pos - 4 * i;
                        v[u][i] &= n >= 4 ? ~0u : n <= 0 ? 0u
                                 : ~0u >> (8 * (4 - n));
                    }
                store16(out + pos, v[u]);
                nzacc |= (v[u][0] | v[u][1] | v[u][2] | v[u][3]) != 0
                       ? 1u << (c & 31) : 0u;
            }
            nzacc = lanes_or(nzacc);
        }
        if (lane == 0)
            nz[g0 >> 5] = ((g0 & 31) ? nz[g0 >> 5] : 0u) | nzacc;
        g0 += kLanes;
    }

    // after the last step: whether the lane is bad by its records or a
    // far copy of a cell that is not literal, which came out zeros, has a
    // source that did not
    SQZ_DEVICE bool verdict() const {
        const int lane = sqz4::lane_id();
        sqz4::warp_sync();
        bool far = false;
        for (int i = lane; i < C; i += kLanes) {
            const uint32_t x = cell[i];
            const uint32_t j = x & kValue;
            const uint32_t r = (x & kKind) == kMatch
                               && j < static_cast<uint32_t>(nm)
                ? rec[j * kpitch] : 0u;
            const uint32_t d = r & 0xFFFFu;
            if ((x & kKind) != kMatch || d <= kCell) continue;
            int src = i - static_cast<int>(d / kCell);
            src = src > 0 ? src : 0;
            if ((cell[src] & kKind) != kLit
                && ((nz[src >> 5] >> (src & 31)) & 1u))
                far = true;
        }
        return sqz4::ballot(far || bad) != 0;
    }
};

// A tile of kTile lanes from lane b0 (a CTA of kTile warps, this thread
// `tid`): lit, tok, mrec and counts point at lane 0 of the decoder's
// outputs (rows B words apart); blocks receives C * 128 bytes a lane and
// bad a flag a lane. smem holds Layout(tw, mw, C).words() words.
//
// The literal cells go first, in rounds of kChunk literal cells a lane
// (the chunk staged for the tile, one barrier a round); then each warp
// fills its lane's other cells with no barrier, reading the literal cells
// they come from back from out (written by the same threads).
template <int kTile, int kChunk, int kBufs>
SQZ_DEVICE void assemble_tile(int tid, int b0, const uint32_t* lit, int lw,
                              const uint32_t* tok, int tw,
                              const uint32_t* mrec, int mw,
                              const int32_t* counts, const int32_t* sizes,
                              int B, int C, uint8_t* blocks, uint8_t* bad,
                              uint32_t* smem) {
    static_assert(kBufs >= 2, "a chunk in flight beside the one written");
    using L = Layout<kTile, kChunk, kBufs>;
    constexpr int kThreads = kTile * kLanes;
    constexpr int kPitch = L::kPitch;
    const L lay(tw, mw, C);
    SQZ_CELL_STAMP(0);
    const int wid = tid / kLanes, lane = sqz4::lane_id();
    const int nl = B - b0 < kTile ? B - b0 : kTile;
    const bool active = wid < nl;
    const int b = b0 + wid;
    uint32_t* s_tok = smem;
    uint32_t* s_rec = smem + lay.rec();
    uint32_t* s_buf = smem + lay.bufs();
    uint32_t* s_cell = smem + lay.lanes() + wid * lay.lane_words();
    int32_t* s_litcell = reinterpret_cast<int32_t*>(s_cell + C);
    uint32_t* s_nz = s_cell + 2 * C;
    int32_t* s_nlit = reinterpret_cast<int32_t*>(s_nz + lay.nzw);
    const int lit_rows = lw < C * kCellWords ? lw : C * kCellWords;
    // the literal rows this thread's lane needs (all of them before the
    // walk has counted its literal cells)
    int lane_rows = lit_rows;
    auto stage_chunk = [&](int j, int rounds) {
        const int r0 = j * L::kChunkRows;
        int r1 = r0 + L::kChunkRows;
        r1 = r1 < lane_rows ? r1 : lane_rows;
        if (j < rounds && r0 < r1)
            stage_rows<kTile, kThreads>(
                tid, lit + b0 + static_cast<long long>(r0) * B, B, r1 - r0,
                nl, s_buf + (j % kBufs) * L::kChunkRows * kPitch);
        stage_commit();
    };
    // the walk's inputs (one group), then the first chunks (a group each)
    stage_rows<kTile, kThreads>(tid, tok + b0, B, tw, nl, s_tok);
    stage_rows<kTile, kThreads>(tid, mrec + b0, B, lay.nm, nl, s_rec);
    stage_commit();
    for (int j = 0; j < kBufs - 1; ++j) stage_chunk(j, kBufs);
    stage_wait<kBufs - 1>();
    cta_sync();
    SQZ_CELL_STAMP(1);
    const int size = active ? sizes[b] : 0;
    const int nc = size <= 0 ? 0 : (size + kCell - 1) / kCell < C
                                        ? (size + kCell - 1) / kCell : C;
    int nlit = 0, tcur = 0;
    if (active)
        tcur = walk<kPitch>(s_tok + wid, tw, size, C, s_cell, s_litcell,
                            &nlit);
    if (lane == 0) *s_nlit = nlit;
    SQZ_CELL_STAMP(2);
    uint8_t* out = blocks + static_cast<long long>(b) * C * kCell;
    Matches mt;
    mt.cell = s_cell;
    mt.rec = s_rec + wid;
    mt.kpitch = kPitch;
    mt.nm = lay.nm;
    mt.C = C;
    mt.nc = nc;
    mt.size = size;
    mt.out = out;
    mt.nz = s_nz;
    mt.scratch = reinterpret_cast<uint32_t*>(s_nlit + 1);
    mt.g0 = C;              // begun in the first round without literals
    const int my_rounds = (nlit + kChunk - 1) / kChunk;
    int rounds = 0;
    for (int k = 0;; ++k) {
        stage_wait<kBufs - 2>();     // chunk k
        cta_sync();
        if (k == 0) {
            int most = 0;
            for (int t = 0; t < kTile; ++t) {
                const int n = reinterpret_cast<const int32_t*>(
                    smem + lay.lanes() + t * lay.lane_words() + 2 * C
                    + lay.nzw)[0];
                most = n > most ? n : most;
            }
            rounds = (most + kChunk - 1) / kChunk;
            const int n = reinterpret_cast<const int32_t*>(
                smem + lay.lanes() + (tid % kTile) * lay.lane_words() + 2 * C
                + lay.nzw)[0];
            lane_rows = n * kCellWords < lit_rows ? n * kCellWords
                                                  : lit_rows;
        }
        if (k >= rounds) break;
        // the buffer of chunk k - 1, written out last round, takes chunk
        // k + kBufs - 1
        stage_chunk(k + kBufs - 1, rounds);
        const int lo = k * kChunk, hi = lo + kChunk < nlit ? lo + kChunk
                                                           : nlit;
        if (!active) continue;
        if (lo < hi) {
            put_literals<kPitch>(
                lo, hi, s_buf + (k % kBufs) * L::kChunkRows * kPitch + wid,
                s_litcell, nc, size, out);
        } else {
            // this lane's literal cells are in out: a step of its other
            // cells while the tile's rounds go on
            if (k == my_rounds) mt.begin();
            if (!mt.done()) mt.step();
        }
    }
    stage_wait<0>();
    SQZ_CELL_STAMP(3);
    if (active) {
        if (my_rounds >= rounds) mt.begin();
        while (!mt.done()) mt.step();
        const bool flag = mt.verdict()
            || tcur != counts[2LL * B + b] || counts[4LL * B + b] != 0
            || counts[6LL * B + b] != 0;
        if (lane == 0) bad[b] = flag;
    }
    SQZ_CELL_STAMP(4);
}

}  // namespace sqz4_cell

#ifdef __CUDACC__

namespace sqz4_cell {

__global__ void __launch_bounds__(kTileLanes * 32)
sqz4_cell_kernel(const uint32_t* __restrict__ lit, int lw,
                 const uint32_t* __restrict__ tok, int tw,
                 const uint32_t* __restrict__ mrec, int mw,
                 const int32_t* __restrict__ counts,
                 const int32_t* __restrict__ sizes, int B, int C,
                 uint8_t* __restrict__ blocks, uint8_t* __restrict__ bad) {
    extern __shared__ uint32_t smem[];
    assemble_tile<kTileLanes, kTileChunk, kTileBufs>(
        threadIdx.x, blockIdx.x * kTileLanes, lit, lw, tok, tw, mrec, mw,
        counts, sizes, B, C, blocks, bad, smem);
}

}  // namespace sqz4_cell

// lit [lw, B], tok [tw, B], mrec [mw, B] u32 and counts [8, B] i32 (one
// group of the decoder's outputs), sizes [B] i32 -> blocks [B, C * 128]
// u8 (every byte written) and bad [B] u8. lw must hold C * 32 words.
// Launches ceil(B / kTileLanes) CTAs on `stream`; returns the cudaError_t
// of the launch.
extern "C" int sqz4_cell_launch(const void* lit, int lw, const void* tok,
                                int tw, const void* mrec, int mw,
                                const void* counts, const void* sizes, int B,
                                int C, void* blocks, void* bad,
                                void* stream) {
    using namespace sqz4_cell;
    if (B == 0) return 0;
    if (C < 1 || C > kMaxCells || lw < C * 32 || tw < 1 || mw < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = 4u * static_cast<size_t>(
        Layout<kTileLanes, kTileChunk, kTileBufs>(tw, mw, C).words());
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            sqz4_cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    sqz4_cell_kernel<<<(B + kTileLanes - 1) / kTileLanes, kTileLanes * 32,
                       smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(lit), lw,
        static_cast<const uint32_t*>(tok), tw,
        static_cast<const uint32_t*>(mrec), mw,
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(sizes), B, C,
        static_cast<uint8_t*>(blocks), static_cast<uint8_t*>(bad));
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
