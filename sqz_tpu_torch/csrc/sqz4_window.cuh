// The op-stream window step: the coder statistics of 32 ops at a time
// from the models in the warp's registers (LaneModels), shared by the
// op-stream encoder's producer warp (csrc/sqz4_encode.cu) and the model
// statistics kernel (csrc/sqz4_model_stats.cu).
//
// Every sqz4 model is a cumulative-count model whose counts grow by one a
// coded symbol (the binary ones too: start(1) = count of 0), so an op's
// statistics are its model's at the window's start plus the counts among
// the window's earlier ops of the same model: start gains those with a
// smaller symbol, size those with an equal one, total all of them. One
// pass of 31 shuffles of a packed (model, symbol) key gives all three,
// whatever the mix of models (pseudo-text mixes ~15 of the 36 a window,
// random bytes two). The base statistics come from the models in the
// lanes' registers, read at each lane's own model and symbol; then the
// window's counts, gathered in a histogram in shared memory, update the
// models at once.
#pragma once

#include "sqz4_chain.cuh"

namespace sqz4 {

// the window histogram's slots: byte and size symbols, bits symbols,
// distance-bit models' zeros and ones
constexpr int kHistByte = 0, kHistSize = 256, kHistBits = 512,
              kHistDist0 = 544, kHistDist1 = 576, kHist = 608;
constexpr int kOpPad = 255;

// n counts of this lane's symbols from the histogram h into model md,
// the entries read cleared
template <int N>
SQZ_DEVICE void absorb(LaneModel<N>& md, int* h, int n) {
    constexpr int kPer = LaneModel<N>::kPer;
    int inc[kPer];
    SQZ_UNROLL()
    for (int k = 0; k < kPer; ++k) {
        inc[k] = h[lane_id() * kPer + k];
        h[lane_id() * kPer + k] = 0;
    }
    md.add(inc, n);
}

// Statistics of the coded ops of the lanes in mask `in` (model mo, symbol
// so a lane): emit(total, start, size) on each such lane; then the models
// md take the window's counts through the histogram `hist` (kHist slots,
// zero between calls).
template <class Emit>
SQZ_DEVICE void window_step(LaneModels& md, int* hist, int mo, int so,
                            unsigned in, Emit emit) {
    const int lane = lane_id();
    const bool mine = (in >> lane) & 1;
    const bool is_byte = mine && mo == kOpByte;
    const bool is_size = mine && mo == kOpSize;
    const bool is_bits = mine && mo == kOpBits;
    const bool is_flag = mine && mo == kOpFlag;
    const bool is_dist = mine && mo >= kOpDist;
    const int sym = is_byte || is_size ? so
                  : is_bits            ? (so < 31 ? so : 31)
                                       : so != 0;
    // the window's earlier ops of the same model: with a smaller symbol,
    // an equal one, any (other lanes' keys never match)
    const int key = mine ? (mo << 8) | sym : 0xFF00;
    int lt = 0, eq = 0, same = 0;
    SQZ_UNROLL()
    for (int j = 0; j < kLanes - 1; ++j) {   // independent shuffles
        const int kj = shfl(key, j);
        const bool b = j < lane && (kj >> 8) == (key >> 8);
        same += b;
        eq += b && kj == key;
        lt += b && kj < key;
    }
    // the models' statistics at the window's start, for each lane's own
    // model and symbol (warp-uniform tests: only the models the window
    // uses are read)
    const unsigned w_byte = ballot(is_byte), w_size = ballot(is_size),
                   w_bits = ballot(is_bits), w_dist = ballot(is_dist),
                   w_flag = ballot(is_flag),
                   w_flag1 = ballot(is_flag && sym);
    int start = 0, size = 0, total = 0, a, b;
    if (w_byte) {
        md.byte.stats_any(is_byte ? sym : 0, &a, &b);
        if (is_byte) start = a, size = b, total = md.byte.total;
    }
    if (w_size) {
        md.size.stats_any(is_size ? sym : 0, &a, &b);
        if (is_size) start = a, size = b, total = md.size.total;
    }
    if (w_bits) {
        md.bits.stats_any(is_bits ? sym : 0, &a, &b);
        if (is_bits) start = a, size = b, total = md.bits.total;
    }
    a = md.lit0, b = md.lit1;
    if (w_dist) {
        int d0, d1;
        md.dist.get_any(is_dist ? mo - kOpDist : 0, &d0, &d1);
        if (is_dist) a = d0, b = d1;
    }
    if (is_flag || is_dist) {
        total = a + b;
        start = sym ? a : 0;
        size = sym ? b : a;
    }
    if (mine) {
        emit(static_cast<uint32_t>(total + same),
             static_cast<uint32_t>(start + lt),
             static_cast<uint32_t>(size + eq));
        if (!is_flag)
            smem_add(&hist[is_byte   ? kHistByte + sym
                           : is_size ? kHistSize + sym
                           : is_bits ? kHistBits + sym
                           : sym     ? kHistDist1 + mo - kOpDist
                                     : kHistDist0 + mo - kOpDist],
                     1);
    }
    warp_sync();
    // the window's counts into the models
    md.lit0 += popc(w_flag & ~w_flag1);
    md.lit1 += popc(w_flag1);
    if (w_byte) absorb(md.byte, hist + kHistByte, popc(w_byte));
    if (w_size) absorb(md.size, hist + kHistSize, popc(w_size));
    if (w_bits) absorb(md.bits, hist + kHistBits, popc(w_bits));
    if (w_dist) {
        constexpr int kPer = LaneBinary<32>::kPer;
        int n0[kPer], n1[kPer];
        SQZ_UNROLL()
        for (int k = 0; k < kPer; ++k) {
            const int i = lane * kPer + k;
            n0[k] = hist[kHistDist0 + i];
            n1[k] = hist[kHistDist1 + i];
            hist[kHistDist0 + i] = hist[kHistDist1 + i] = 0;
        }
        md.dist.add(n0, n1);
    }
    warp_sync();
}

}  // namespace sqz4
