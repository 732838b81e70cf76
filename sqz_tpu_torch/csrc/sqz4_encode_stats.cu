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
// The host caller keeps the reference's contract that totals stay below
// 2^15 (the TPU kernel's f32 long division is exact only there); the
// hardware 64-bit divide here has no such limit.
//
// What bounds it: as the other coders, one serial dependence chain per
// block (64-bit divide -> multiply -> renormalize, op after op) and as
// many chains as blocks; the statistics arrive precomputed, so the chain
// holds no model lookup. The design: one thread per block reading its
// three columns row by row, the coder step Encoder::code_stats shared with
// the model-driven encoders, no tables and no shared memory; one block a
// CTA, as the other coders, whose data-dependent emission loops diverge
// within a warp (PERF.md, PR 1).

#include "sqz4_coder.cuh"

namespace sqz4 {

// Encode one block's statistics. Pointers are offset to the lane; rows of
// the inputs and of words are `lanes` elements apart. The output column
// must be zero-filled by the caller.
SQZ_DEVICE void encode_stats_lane(const uint32_t* start, const uint32_t* size,
                                  const uint32_t* total, int rows, int lanes,
                                  uint32_t* words, int cap_words,
                                  int32_t* len_out) {
    Encoder enc = make_encoder(words, lanes, cap_words, nullptr, 0);
    for (int t = 0; t < rows; ++t) {
        const long long r = static_cast<long long>(t) * lanes;
        const uint32_t tt = total[r];
        if (tt == 0) continue;   // pad
        const uint32_t sz = size[r];
        if (sz == 0)
            enc.flush();
        else
            enc.code_stats(start[r], sz, tt);
    }
    *len_out = enc.finish();
}

}  // namespace sqz4

#ifdef __CUDACC__

__global__ void sqz4_encode_stats_kernel(const uint32_t* __restrict__ start,
                                         const uint32_t* __restrict__ size,
                                         const uint32_t* __restrict__ total,
                                         int n_lanes, int rows, int lanes,
                                         uint32_t* __restrict__ words,
                                         int cap_words,
                                         int32_t* __restrict__ lens) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= n_lanes) return;
    const long long g = n / lanes, b = n % lanes;
    const long long in = g * rows * lanes + b;
    sqz4::encode_stats_lane(start + in, size + in, total + in, rows, lanes,
                            words + g * cap_words * lanes + b, cap_words,
                            lens + g * 8 * lanes + b);
}

// start, size, total: [groups, rows, lanes] u32; words: [groups,
// cap_words, lanes] u32, zero-filled; lens: [groups, 8, lanes] i32,
// zero-filled. Launches on `stream`; returns the cudaError_t of the
// launch.
extern "C" int sqz4_encode_stats_launch(const void* start, const void* size,
                                        const void* total, int groups,
                                        int rows, int lanes, void* words,
                                        int cap_words, void* lens,
                                        int threads, void* stream) {
    const int n_lanes = groups * lanes;
    const int ctas = (n_lanes + threads - 1) / threads;
    sqz4_encode_stats_kernel<<<ctas, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(start),
        static_cast<const uint32_t*>(size),
        static_cast<const uint32_t*>(total), n_lanes, rows, lanes,
        static_cast<uint32_t*>(words), cap_words,
        static_cast<int32_t*>(lens));
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
