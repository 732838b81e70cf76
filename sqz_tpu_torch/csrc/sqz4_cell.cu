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
// What it computes, for each lane (one CTA), as the plain version
// (sqz_tpu_torch/ops/resident.py:assemble_cells_ref) does:
//   pass 1 (one thread, the cells in order): a cell is a match cell iff
//     the token at the walk's cursor is a match; the match must be a
//     len-128 match at a power-of-2 dist <= 128 (a periodic fill) or at a
//     cell-aligned dist within the block (a far copy), in a full cell,
//     else the lane is bad. The cursor moves one token on a match and one
//     a byte on a literal cell. Reads past the staged rows give 0, as
//     the reference's one-hot reads do. The lane is also bad when the
//     walk did not consume exactly ntok tokens, or the decoder flagged it;
//   passes 2 and 3 (the CTA, a thread a byte, the cells in order): a
//     literal cell takes the next cell of the literal stream, a periodic
//     cell the previous output cell's tail (prev[128 - d + j % d]), a far
//     copy the literal bytes of its source cell (zeros if the source is
//     not a literal cell), any other cell zeros; bytes past the block's
//     size are written as zeros;
//   the far-copy check: the reference compares each far copy with its
//     source's output after assembly (out[c] == out[src]). A far copy is
//     its source's literal bytes when the source is a literal cell, equal
//     to the source's output by construction; otherwise it is zeros, so
//     the check is that the source's output is all zeros. The CTA's
//     barrier at each cell is a __syncthreads_or that says whether the
//     cell came out nonzero, and thread 0 keeps that flag a cell.
//
// What bounds it: bytes (every literal read once, every block byte
// written once, the token and record columns read once: about 56 MB at
// 512 x 64 KiB of the resident mix, 0.017 ms at 3.35 TB/s). This first
// design is bound by latency instead: the classify walk is serial in one
// thread (a shared-memory read a cell), and the fill is a chain of one
// barrier a cell, since a periodic cell reads the previous cell's output.
// The design keeps the walk's inputs in shared memory (the lane's
// token-bit column, 8.3 KiB at 64 KiB blocks, and its first C match
// records) and the previous output cell in a double buffer (one barrier
// a cell). The literal sources of the next kCellRing - 1 cells are in
// flight into a ring in shared memory (cp.async), so the chain does not
// wait on a literal cell's load (loading them into registers 16 cells
// ahead measured 0.38 ms a group against the ring's 0.29, PERF.md). A
// CTA takes 16.9 KiB of shared memory at 64 KiB blocks, so all 512
// lanes of a group are resident at once.
//
// What a host compiler sees: the lane body as plain C++ with kThreads
// threads a CTA; cta_sync / cta_any are no-ops for one thread, and a host
// includer that defines SQZ_HOST_CTA supplies them for a CTA of host
// threads (tests/test_torch_csrc_host.py). The kernel and its launcher
// are device code.

#include <stdint.h>

#ifndef SQZ_DEVICE
#define SQZ_DEVICE __device__ __forceinline__
#endif

namespace sqz4_cell {

constexpr int kCell = 128;
// a cell's code in pass 1's table: its kind in the top two bits, and
// below them the literal cell it reads, its period, or its source cell
constexpr uint32_t kKind = 3u << 30;
constexpr uint32_t kZero = 0u;
constexpr uint32_t kLit = 1u << 30;
constexpr uint32_t kPeriodic = 2u << 30;
constexpr uint32_t kFar = 3u << 30;
constexpr uint32_t kValue = ~kKind;
// the kernel's CTA: one thread a byte of a cell, and the cells of its
// ring of literal sources in shared memory
constexpr int kCellThreads = kCell;
constexpr int kCellRing = 32;

#ifdef __CUDACC__
SQZ_DEVICE void cta_sync() { __syncthreads(); }
// a barrier that returns whether p held on any thread of the CTA
SQZ_DEVICE bool cta_any(bool p) { return __syncthreads_or(p) != 0; }
#elif !defined(SQZ_HOST_CTA)   // else the includer defines these
SQZ_DEVICE void cta_sync() {}
SQZ_DEVICE bool cta_any(bool p) { return p; }
#endif

// Pass 1: walk the C cells of a lane of `size` bytes through its token
// bits (tokw, tw words) and match records (rec, the first nm), writing
// each cell's code to cell[]. Sets *bad for a match that is not a cell
// match; returns the tokens consumed.
SQZ_DEVICE int classify_cells(const uint32_t* tokw, int tw,
                              const uint32_t* rec, int nm, int size, int C,
                              uint32_t* cell, bool* bad) {
    int tcur = 0, mcur = 0;
    uint32_t nlit = 0;
    for (int c = 0; c < C; ++c) {
        const int rem = size - c * kCell;
        const int remaining = rem > 0 ? rem : 0;
        const int wi = tcur >> 5;
        const uint32_t word = wi < tw ? tokw[wi] : 0u;
        const bool ismatch = remaining > 0 && ((word >> (tcur & 31)) & 1u);
        if (ismatch) {
            const uint32_t r = mcur < nm ? rec[mcur] : 0u;
            const uint32_t d = r & 0xFFFFu, mlen = r >> 16;
            const bool okd = d > 0 && d <= kCell && (d & (d - 1)) == 0;
            const bool okfar = d > kCell && d % kCell == 0
                               && d <= static_cast<uint32_t>(c) * kCell;
            if (mlen != kCell || !(okd || okfar) || remaining < kCell)
                *bad = true;
            const int src = c - static_cast<int>(d / kCell);
            cell[c] = okd ? kPeriodic | d
                    : d > kCell ? kFar | static_cast<uint32_t>(
                                             src > 0 ? src : 0)
                    : kZero;
            tcur += 1;
            mcur += 1;
        } else if (remaining > 0) {
            cell[c] = kLit | nlit++;
            tcur += remaining < kCell ? remaining : kCell;
        } else {
            cell[c] = kZero;
        }
    }
    return tcur;
}

#ifdef __CUDACC__
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
#else
SQZ_DEVICE void stage_word(uint32_t* dst, const uint32_t* src) {
    *dst = *src;
}
SQZ_DEVICE void stage_commit() {}
template <int kPending>
SQZ_DEVICE void stage_wait() {}
#endif

// The literal cell that cell c's bytes come from before the periodic
// fill: its own for a literal cell, its source's for a far copy of a
// literal cell; -1 (zeros) for any other cell.
SQZ_DEVICE int literal_source(const uint32_t* cell, int c) {
    uint32_t x = cell[c];
    if ((x & kKind) == kFar) x = cell[x & kValue];
    return (x & kKind) == kLit ? static_cast<int>(x & kValue) : -1;
}

// Start copying cell c's literal source (32 words of the lane's literal
// column, rows B apart) into its ring slot, one word a thread below 32;
// every thread commits a group (empty past the last cell or for a cell
// with no literal source), so the group counts stay in step.
template <int kThreads, int kRing>
SQZ_DEVICE void stage_cell(int tid, const uint32_t* cell, int c, int C,
                           const uint32_t* lit, long long B,
                           uint32_t* ring) {
    const int li = c < C ? literal_source(cell, c) : -1;
    if (li >= 0)
        for (int w = tid; w < kCell / 4; w += kThreads)
            stage_word(ring + (c % kRing) * (kCell / 4) + w,
                       lit + (static_cast<long long>(li) * (kCell / 4) + w)
                                 * B);
    stage_commit();
}

// Shared memory of a lane (32-bit words) with a ring of `ring` cells:
// the token bits, the first min(C, mw) match records, the cell codes,
// the ring, the two previous-cell buffers and a nonzero flag a cell (the
// launcher sizes the kernel's dynamic shared memory by it: host code).
inline int smem_words(int tw, int mw, int C, int ring) {
    return tw + (mw < C ? mw : C) + C + ring * kCell / 4 + 2 * kCell / 4
           + (C + 3) / 4;
}

// One lane (one CTA of kThreads threads, this one `tid`): lit, tok and
// mrec point at the lane's column of the decoder's outputs (rows B words
// apart), counts at its counts column; out receives the lane's C * 128
// bytes and *bad its flag. smem holds smem_words(tw, mw, C, kRing) words.
// The literal sources of the next kRing - 1 cells are in flight into a
// ring of shared memory while the chain fills cell c.
template <int kThreads, int kRing>
SQZ_DEVICE void assemble_lane(int tid, const uint32_t* lit,
                              const uint32_t* tok, int tw,
                              const uint32_t* mrec, int mw,
                              const int32_t* counts, int size, long long B,
                              int C, uint8_t* out, uint8_t* bad,
                              uint32_t* smem) {
    static_assert(kCell % kThreads == 0, "whole bytes a thread");
    static_assert(kRing >= 2, "a cell in flight beside the one filled");
    const int nm = mw < C ? mw : C;
    uint32_t* s_tok = smem;
    uint32_t* s_rec = s_tok + tw;
    uint32_t* s_cell = s_rec + nm;
    uint32_t* s_ring = s_cell + C;
    uint8_t* s_prev = reinterpret_cast<uint8_t*>(s_ring + kRing * kCell / 4);
    uint8_t* s_nz = s_prev + 2 * kCell;
    for (int i = tid; i < tw; i += kThreads) s_tok[i] = tok[i * B];
    for (int i = tid; i < nm; i += kThreads) s_rec[i] = mrec[i * B];
    for (int i = tid; i < kCell; i += kThreads) s_prev[kCell + i] = 0;
    cta_sync();
    bool flag = false;
    if (tid == 0) {
        const int tcur = classify_cells(s_tok, tw, s_rec, nm, size, C,
                                        s_cell, &flag);
        flag = flag || tcur != counts[2 * B] || counts[4 * B] != 0
               || counts[6 * B] != 0;
    }
    cta_sync();
    for (int c = 0; c < kRing - 1; ++c)
        stage_cell<kThreads, kRing>(tid, s_cell, c, C, lit, B, s_ring);
    stage_wait<kRing - 2>();     // cell 0's group
    cta_sync();
    for (int c = 0; c < C; ++c) {
        // the slot of cell c - 1, filled last step, takes cell
        // c + kRing - 1
        stage_cell<kThreads, kRing>(tid, s_cell, c + kRing - 1, C, lit, B,
                                    s_ring);
        const uint32_t x = s_cell[c];
        const uint32_t d = x & kValue;
        const bool lit_src = literal_source(s_cell, c) >= 0;
        const uint32_t* slot = s_ring + (c % kRing) * (kCell / 4);
        const uint8_t* prev = s_prev + ((c + 1) & 1) * kCell;
        uint8_t* cur = s_prev + (c & 1) * kCell;
        bool nz = false;
        for (int j = tid; j < kCell; j += kThreads) {
            const uint32_t v = (x & kKind) == kPeriodic
                ? prev[kCell - d + (j & (d - 1))]
                : lit_src ? (slot[j >> 2] >> (24 - 8 * (j & 3))) & 0xFFu
                          : 0u;
            cur[j] = static_cast<uint8_t>(v);
            nz = nz || v != 0;
            const int pos = c * kCell + j;
            out[pos] = static_cast<uint8_t>(pos < size ? v : 0u);
        }
        stage_wait<kRing - 2>();     // cell c + 1's group
        nz = cta_any(nz);
        if (tid == 0) {
            s_nz[c] = nz;
            // a far copy of a cell that is not literal came out zeros:
            // its source must have too
            if ((x & kKind) == kFar && (s_cell[d] & kKind) != kLit
                && s_nz[d])
                flag = true;
        }
    }
    if (tid == 0) *bad = flag;
}

}  // namespace sqz4_cell

#ifdef __CUDACC__

namespace sqz4_cell {

__global__ void __launch_bounds__(kCellThreads)
sqz4_cell_kernel(const uint32_t* __restrict__ lit,
                 const uint32_t* __restrict__ tok, int tw,
                 const uint32_t* __restrict__ mrec, int mw,
                 const int32_t* __restrict__ counts,
                 const int32_t* __restrict__ sizes, int B, int C,
                 uint8_t* __restrict__ blocks, uint8_t* __restrict__ bad) {
    extern __shared__ uint32_t smem[];
    const int b = blockIdx.x;
    assemble_lane<kCellThreads, kCellRing>(
        threadIdx.x, lit + b, tok + b, tw, mrec + b, mw, counts + b,
        sizes[b], B, C, blocks + static_cast<long long>(b) * C * kCell,
        bad + b, smem);
}

}  // namespace sqz4_cell

// lit [lw, B], tok [tw, B], mrec [mw, B] u32 and counts [8, B] i32 (one
// group of the decoder's outputs), sizes [B] i32 -> blocks [B, C * 128]
// u8 (every byte written) and bad [B] u8. lw must hold C * 32 words.
// Launches B CTAs on `stream`; returns the cudaError_t of the launch.
extern "C" int sqz4_cell_launch(const void* lit, int lw, const void* tok,
                                int tw, const void* mrec, int mw,
                                const void* counts, const void* sizes, int B,
                                int C, void* blocks, void* bad,
                                void* stream) {
    if (B == 0) return 0;
    if (C < 1 || lw < C * 32 || tw < 1 || mw < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = 4u * sqz4_cell::smem_words(tw, mw, C,
                                                       sqz4_cell::kCellRing);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            sqz4_cell::sqz4_cell_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    sqz4_cell::sqz4_cell_kernel<<<B, sqz4_cell::kCellThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(lit), static_cast<const uint32_t*>(tok),
        tw, static_cast<const uint32_t*>(mrec), mw,
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(sizes), B, C,
        static_cast<uint8_t*>(blocks), static_cast<uint8_t*>(bad));
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
