// sqz4 stats-fed block encoder for Hopper (sm_90a).
//
// Replaces the TPU kernel sqz_tpu/ops/sqz4_pallas.py:_encode_kernel
// (launcher _encode_pallas), the round-1 encoder behind encode_groups. Its
// input is the coder's statistics of every op, computed on the host
// (native sqz4_model_stats: each op's start, size and total before the
// model update): start / size / total uint32 [G, T, B]. Per op, total == 0
// is a pad (codes nothing), total != 0 with size == 0 a flush (one
// emission of the top byte), anything else is coded. Output as the other
// encoders: words uint32 [G, cap_words, B] (big-endian bytes; bytes past
// cap_words * 4 are dropped) and lens int32 [G, 8, B] (row 0 = payload
// byte length, which may exceed the capacity).
//
// On this slice's route above 64 KiB blocks it is also the counterpart of
// the reference's scan coder sqz_tpu/ops/sqz4_jax.py:_encode_scan_stats
// (sqz4_cuda.encode_data_stats). The kernel's divide is exact for every
// total below 2^32 (sqz4_div.cuh), so it takes any block up to
// 2^kMaxBlockBits bytes, whose totals stay below kTotalLimit; its rows
// and offsets are 64-bit where a group's [T, lanes] passes 2^31
// elements. encode_groups, the caller for the reference's Pallas
// encoder, keeps that kernel's tighter contract, totals below 2^15 (its
// f32 long division is exact only there).
//
// What bounds it: as the other coders, one serial dependence chain per
// block (divide -> multiply -> renormalize, op after op) and as many
// chains as blocks. The one-thread design before this one spent ~2,600
// SM cycles a symbol: three strided global loads an op and a software
// u64 divide sat on its chain.
//
// What the design does about it: the token encoder's two warps
// (sqz4_pair.cuh), with no models. A producer warp (StatsProducer) stages
// the three columns a chunk ahead (Stager, an element a lane at the
// column's stride), takes 32 ops at a time, drops the pads by a ballot
// and a popcount, ends a buffer at a flush (the flushes follow its ops)
// and computes the reciprocals side by side. A coder warp runs only
// ChainCoder::code per op: no `/` and no load on its chain. Four blocks a
// CTA, one coder chain on each of an SM's schedulers. The host tests
// build this file with g++, where a warp is one lane (sqz4_warp.cuh).

#include "sqz4_pair.cuh"

namespace sqz4 {

struct StatsSmem {
    uint32_t start[2 * kStage];
    uint32_t size[2 * kStage];
    uint32_t total[2 * kStage];
    PairBufs pair;
};

// Turns a block's rows of statistics into coder ops, kLanes rows at a
// time.
struct StatsProducer {
    Stager<uint32_t> st, sz, tt;
    int rows;   // rows in the stream
    int o;      // the next row
    bool done;

    SQZ_DEVICE void init(StatsSmem* sm, const uint32_t* start,
                         const uint32_t* size, const uint32_t* total,
                         int n, int lanes) {
        st.init(start, n, lanes, sm->start);
        sz.init(size, n, lanes, sm->size);
        tt.init(total, n, lanes, sm->total);
        rows = n;
        o = 0;
        done = n == 0;
    }

    // The window of rows o .. o + kLanes - 1 (zeros past the stream:
    // pads) into buffer r from entry *n on, after *flushes flushes;
    // returns true when it ends the buffer.
    SQZ_DEVICE bool window(Ring& r, int* n, int* flushes) {
        const int p = o + lane_id();
        st.ensure(o + kLanes - 1);
        sz.ensure(o + kLanes - 1);
        tt.ensure(o + kLanes - 1);
        const uint32_t total = tt.at(p), size = sz.at(p);
        const bool coded = total != 0 && size != 0;
        const Take w = take_window(ballot(coded),
                                   ballot(total != 0 && size == 0),
                                   flushes);
        const unsigned in = ballot(coded && lane_id() < w.seg);
        if ((in >> lane_id()) & 1)
            entry(r, *n + popc(in & below(lane_id())), total, st.at(p),
                  size);
        *n += popc(in);
        o += w.adv;
        done = o >= rows;
        return w.end;
    }

    SQZ_DEVICE bool fill(Ring& r) { return fill_windows(*this, r); }
};

// Encode one block's statistics (rows rows of each column, `lanes`
// elements apart). words / len_out are offset to the lane; rows of words
// are `lanes` elements apart and must be zero-filled by the caller. role
// and bar as in sqz4_pair.cuh (kRoleBoth: one warp, or the host).
SQZ_DEVICE void encode_stats_lane(const uint32_t* start, const uint32_t* size,
                                  const uint32_t* total, int rows, int lanes,
                                  uint32_t* words, int cap_words,
                                  int32_t* len_out, StatsSmem* sm, int role,
                                  int bar) {
    if (role == kRoleConsumer) {
        code_buffers(&sm->pair, bar);
        return;
    }
    StatsProducer prod;
    prod.init(sm, start, size, total, rows, lanes);
    produce_buffers(prod, &sm->pair, role, bar, words, lanes, cap_words,
                    len_out);
}

}  // namespace sqz4

#ifdef __CUDACC__

// One block a pair of warps (or one warp at 32 threads a CTA), up to
// four blocks a CTA: sqz4_pair.cuh.
__global__ void __launch_bounds__(64 * sqz4::kMaxBlocks)
sqz4_encode_stats_kernel(const uint32_t* __restrict__ start,
                         const uint32_t* __restrict__ size,
                         const uint32_t* __restrict__ total, int n_lanes,
                         int rows, int lanes, uint32_t* __restrict__ words,
                         int cap_words, int32_t* __restrict__ lens) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const sqz4::PairSlot at = sqz4::pair_slot();
    if (at.n >= n_lanes) return;
    const long long g = at.n / lanes, b = at.n % lanes;
    const long long in = g * rows * lanes + b;
    sqz4::encode_stats_lane(start + in, size + in, total + in, rows, lanes,
                            words + g * cap_words * lanes + b, cap_words,
                            lens + g * 8 * lanes + b,
                            reinterpret_cast<sqz4::StatsSmem*>(smem_raw)
                                + at.j,
                            at.role, 4 * at.j);
}

// start, size, total: [groups, rows, lanes] u32; words: [groups,
// cap_words, lanes] u32, zero-filled; lens: [groups, 8, lanes] i32,
// zero-filled; totals below 2^32 (kTotalLimit for the widest block).
// threads: 32, 64, 128, 192 or 256 a CTA.
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int sqz4_encode_stats_launch(const void* start, const void* size,
                                        const void* total, int groups,
                                        int rows, int lanes, void* words,
                                        int cap_words, void* lens,
                                        int threads, void* stream) {
    const int n_lanes = groups * lanes;
    return sqz4::pair_launch(
        sqz4_encode_stats_kernel, sizeof(sqz4::StatsSmem), n_lanes, threads,
        stream, static_cast<const uint32_t*>(start),
        static_cast<const uint32_t*>(size),
        static_cast<const uint32_t*>(total), n_lanes, rows, lanes,
        static_cast<uint32_t*>(words), cap_words,
        static_cast<int32_t*>(lens));
}

#endif  // __CUDACC__
