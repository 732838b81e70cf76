// sqz4 per-op model statistics for Hopper (sm_90a): the stats-fed
// encoder's input (csrc/sqz4_encode_stats.cu) computed on the card from
// the exact planner's op streams.
//
// Replaces no Pallas kernel. It replaces the host loop of the
// reference's route above 64 KiB blocks, stats_for_ops
// (sqz_tpu/ops/sqz4_jax.py:367): one native sqz4_model_stats call a
// block, which walks the block's ops one after another and reports each
// op's (start, size, total) before its model's update. At 10^8 B of text
// in 1 MiB blocks that loop took 2.8 s of a 6.7-s compress on an H100's
// host, the card idle, and its three [blocks, ops] u32 arrays then went
// up whole.
//
// Input: the packed op streams m_words / s_words, uint32 [n, rows], block
// i's ops in row i, four big-endian u8 ops a word (the op codes of
// csrc/sqz4_encode.cu: 0 flag, 1 size, 2 byte, 3 bits (symbol clamped to
// 31), 4..35 distance bit (symbol read as s != 0), 254 flush, anything
// else a pad). Output: start, size and total uint32 [G, 4 * rows, lanes],
// block i on lane i % lanes of group i / lanes, as the stats-fed encoder
// reads them: a coded op's statistics, a flush (0, 0, 1), a pad
// (0, 0, 0); lanes past n are left to the caller.
//
// What it computes: every sqz4 model is a cumulative-count model whose
// counts start at 1, or at a warm seed's (FORMAT.md §3.1), and grow by
// one a coded symbol, with no rescale inside a block. So an op's total is
// its model's starting total plus the earlier ops of the model, its size
// the starting count of its symbol plus the earlier ops of that (model,
// symbol), its start the starting counts below the symbol plus the
// earlier ops of the model with a smaller symbol: prefix counts over the
// block's stream. Each block's stream is cut into chunks of kChunkOps
// ops, and the counts before a chunk are its base state:
//   - pass 1 (sqz4_model_hist_kernel): a warp a chunk counts the chunk's
//     coded ops into the 610 (model, symbol) bins of the kSeed* layout
//     (sqz4_chain.cuh) and writes them in its csum form;
//   - between the passes (sqz4_cuda.model_stats, in PyTorch): each
//     chunk's base state is the starting column plus the sum of the
//     block's earlier chunks', in the same form;
//   - pass 2 (sqz4_model_stats_kernel): a warp a chunk starts LaneModels
//     from its base state and walks the chunk 32 ops a window with the
//     op-stream encoder's window step (sqz4_window.cuh), writing each
//     op's statistics.
//
// What bounds it: bytes. Each op's two u8 codes are read twice and its
// 12 bytes of statistics written once; the histograms and the base
// states, 2.4 KB a chunk each way, add about 1/30 of that at 2^13 ops a
// chunk. Adjacent warps, in one CTA and in the next, hold one chunk of
// adjacent blocks, so their strided stores (a row of the output is
// `lanes` words) meet in the same sectors at about the same time.
//
// Why chunks: the op-stream encoder's producer warp computes the same
// statistics, one warp a block walking its whole stream. At the wide
// route's 96 lanes of some 800,000 ops that is 96 warps on 132 SMs, each
// stepping 25,000 windows in turn; cut into chunks of 2^13 ops the same
// work is about 9,500 warps of 256 windows.
//
// The host tests build this file with g++ (count_chunk, stats_chunk on
// a warp of one lane, and of 32 host threads); the kernels and the
// launchers are device code.

#include "sqz4_window.cuh"

namespace sqz4 {

constexpr int kChunkOps = 1 << 13;   // ops a chunk
constexpr int kStatsWarps = 4;       // warps (chunks) a CTA

// op p of a block's packed stream
SQZ_DEVICE int op_at(const uint32_t* words, long long p) {
    return (words[p >> 2] >> (24 - 8 * (p & 3))) & 0xFF;
}

// The kSeed* bin of a coded op (model mo < kOpDist + 32, symbol so).
SQZ_DEVICE int seed_bin(int mo, int so) {
    return mo == kOpByte   ? kSeedByte + so
         : mo == kOpSize   ? kSeedSize + so
         : mo == kOpBits   ? kSeedBits + (so < 31 ? so : 31)
         : mo == kOpFlag   ? kSeedLit + (so != 0)
         : so              ? kSeedDist1 + mo - kOpDist
                           : kSeedDist0 + mo - kOpDist;
}

// h[0, N) into its inclusive running sums, kPer entries a lane.
template <int N>
SQZ_DEVICE void running_sums(int* h) {
    constexpr int kPer = N / kLanes;
    int v[kPer], run = 0;
    SQZ_UNROLL()
    for (int k = 0; k < kPer; ++k) {
        run += h[lane_id() * kPer + k];
        v[k] = run;
    }
    const int below = warp_exscan(run);
    SQZ_UNROLL()
    for (int k = 0; k < kPer; ++k) h[lane_id() * kPer + k] = v[k] + below;
    warp_sync();
}

// Pass 1, one chunk: the coded ops among ops [p0, p0 + len) of a block's
// streams m / s counted into out[0, kSeedWords) in the kSeed* csum form
// (the byte, size and bits models' running sums, the literal flag's and
// the distance bits' counts), through h, kSeedWords ints of shared
// memory.
SQZ_DEVICE void count_chunk(const uint32_t* m, const uint32_t* s,
                            long long p0, int len, int* h, int32_t* out) {
    for (int i = lane_id(); i < kSeedWords; i += kLanes) h[i] = 0;
    warp_sync();
    for (int i = lane_id(); i < len; i += kLanes) {
        const int mo = op_at(m, p0 + i);
        if (mo < kOpDist + 32) smem_add(&h[seed_bin(mo, op_at(s, p0 + i))], 1);
    }
    warp_sync();
    running_sums<256>(h + kSeedByte);
    running_sums<256>(h + kSeedSize);
    running_sums<32>(h + kSeedBits);
    for (int i = lane_id(); i < kSeedWords; i += kLanes) out[i] = h[i];
    warp_sync();
}

// Pass 2, one chunk: the statistics of ops [p0, p0 + len) of a block's
// streams m / s, its models started from base (kSeed* csum form), into
// start / size / total (offset to the block's lane; op p at p * lanes),
// through hist, kHist ints of shared memory.
SQZ_DEVICE void stats_chunk(const uint32_t* m, const uint32_t* s,
                            long long p0, int len, const int32_t* base,
                            int* hist, uint32_t* start, uint32_t* size,
                            uint32_t* total, int lanes) {
    LaneModels md;
    md.init(base);
    for (int i = lane_id(); i < kHist; i += kLanes) hist[i] = 0;
    warp_sync();
    for (int o = 0; o < len; o += kLanes) {
        const bool live = o + lane_id() < len;
        const long long p = p0 + o + lane_id();
        const int mo = live ? op_at(m, p) : kOpPad;
        const int so = live ? op_at(s, p) : 0;
        const unsigned in = ballot(mo < kOpDist + 32);
        uint32_t st = 0, sz = 0, tt = mo == kOpFlush;
        if (in)
            window_step(md, hist, mo, so, in,
                        [&](uint32_t t, uint32_t a, uint32_t b) {
                            tt = t, st = a, sz = b;
                        });
        if (live) {
            start[p * lanes] = st;
            size[p * lanes] = sz;
            total[p * lanes] = tt;
        }
    }
}

}  // namespace sqz4

#ifdef __CUDACC__

namespace sqz4 {

// The chunk of warp w of a launch of n blocks: chunks lane-minor, so
// adjacent warps take adjacent blocks' chunk c. Returns false past the
// last.
struct ChunkAt {
    long long block, chunk;
};

__device__ __forceinline__ bool chunk_at(int n, int chunks, ChunkAt* at) {
    const long long w = static_cast<long long>(blockIdx.x) * kStatsWarps
                        + (threadIdx.x >> 5);
    at->block = w % n;
    at->chunk = w / n;
    return at->chunk < chunks;
}

__global__ void __launch_bounds__(32 * kStatsWarps)
sqz4_model_hist_kernel(const uint32_t* __restrict__ m,
                       const uint32_t* __restrict__ s, int n, int rows,
                       int32_t* __restrict__ hist) {
    __shared__ int h[kStatsWarps][kSeedWords];
    ChunkAt at;
    const int ops = 4 * rows, chunks = (ops + kChunkOps - 1) / kChunkOps;
    if (!chunk_at(n, chunks, &at)) return;
    const long long p0 = at.chunk * kChunkOps, row = at.block * rows;
    count_chunk(m + row, s + row, p0,
                static_cast<int>(min(static_cast<long long>(kChunkOps),
                                     ops - p0)),
                h[threadIdx.x >> 5],
                hist + (at.block * chunks + at.chunk) * kSeedWords);
}

__global__ void __launch_bounds__(32 * kStatsWarps)
sqz4_model_stats_kernel(const uint32_t* __restrict__ m,
                        const uint32_t* __restrict__ s, int n, int rows,
                        int lanes, const int32_t* __restrict__ base,
                        uint32_t* __restrict__ start,
                        uint32_t* __restrict__ size,
                        uint32_t* __restrict__ total) {
    __shared__ int hist[kStatsWarps][kHist];
    ChunkAt at;
    const int ops = 4 * rows, chunks = (ops + kChunkOps - 1) / kChunkOps;
    if (!chunk_at(n, chunks, &at)) return;
    const long long p0 = at.chunk * kChunkOps, row = at.block * rows;
    const long long out = at.block / lanes * ops * lanes + at.block % lanes;
    stats_chunk(m + row, s + row, p0,
                static_cast<int>(min(static_cast<long long>(kChunkOps),
                                     ops - p0)),
                base + (at.block * chunks + at.chunk) * kSeedWords,
                hist[threadIdx.x >> 5], start + out, size + out, total + out,
                lanes);
}

// CTAs of kStatsWarps warps for n blocks of `chunks` chunks each
inline unsigned stats_ctas(int n, int chunks) {
    return static_cast<unsigned>(
        (static_cast<long long>(n) * chunks + kStatsWarps - 1) / kStatsWarps);
}

}  // namespace sqz4

// m, s: [n, rows] u32 (block i's packed ops in row i); hist: [n, chunks,
// kSeedWords] i32, chunks = ceil(4 * rows / kChunkOps), every word
// written. Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int sqz4_model_hist_launch(const void* m, const void* s, int n,
                                      int rows, void* hist, void* stream) {
    const int chunks = (4 * rows + sqz4::kChunkOps - 1) / sqz4::kChunkOps;
    if (n <= 0 || chunks <= 0) return 0;
    sqz4::sqz4_model_hist_kernel<<<sqz4::stats_ctas(n, chunks),
                                   32 * sqz4::kStatsWarps, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(m), static_cast<const uint32_t*>(s), n,
        rows, static_cast<int32_t*>(hist));
    return static_cast<int>(cudaGetLastError());
}

// m, s as above; base: [n, chunks, kSeedWords] i32, each chunk's starting
// models (kSeed* csum form); start, size, total: [ceil(n / lanes),
// 4 * rows, lanes] u32, every op of blocks 0..n-1 written (lanes past n
// untouched). Launches on `stream`; returns the cudaError_t of the
// launch.
extern "C" int sqz4_model_stats_launch(const void* m, const void* s, int n,
                                       int rows, int lanes, const void* base,
                                       void* start, void* size, void* total,
                                       void* stream) {
    const int chunks = (4 * rows + sqz4::kChunkOps - 1) / sqz4::kChunkOps;
    if (n <= 0 || chunks <= 0) return 0;
    sqz4::sqz4_model_stats_kernel<<<sqz4::stats_ctas(n, chunks),
                                    32 * sqz4::kStatsWarps, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(m), static_cast<const uint32_t*>(s), n,
        rows, lanes, static_cast<const int32_t*>(base),
        static_cast<uint32_t*>(start), static_cast<uint32_t*>(size),
        static_cast<uint32_t*>(total));
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
