// Element-wise primitive probes for Hopper (sm_90a).
//
// Replaces the TPU kernels of tools/pallas_probe.py (`run`, which wraps
// each probe body in a pallas_call, and `smem_kernel`, the scalar-memory
// probe): fourteen small checks of the integer and float primitives the
// coder kernels are built from. Each probe here computes what its Pallas
// body computes, on the same inputs (sqz_tpu_torch/ops/probe.py holds
// them, their plain PyTorch versions and the expected values). The one
// exception is u64_native: it computes what that probe asks for, the
// native 64-bit high word. The reference script runs with 64-bit types
// off, so there its body works on u32 and gives 0.
//
//    0 var_shl           x << s, per-lane shift counts
//    1 var_shr           x >> s
//    2 clz_u32           leading zeros of x (32 for 0)
//    3 mul_lo            low 32 bits of x * (s + 3)
//    4 mulhi_emul        high 32 bits of x * y
//    5 sublane_reduce    column sums of t [256, B]
//    6 sublane_cumsum    column prefix sums of t
//    7 while_loop        x doubled ten times in a loop
//    8 onehot_extract    t[idx[b], b] (the TPU gathered by a one-hot sum)
//    9 f32_div           num / den by an f32 reciprocal, then corrected
//   10 u8_convert        row 0 of a u8 [64, B] buffer widened to u32
//   11 dyn_sublane_read  row off of t, off read at run time
//   12 smem_scalar       row 0 of t plus a scalar
//   13 u64_native        high 32 bits of the 64-bit x * x
//
// Inputs a and b are [rows, lanes] arrays (u32 unless noted: u8 for
// u8_convert's a, i32 for dyn_sublane_read's b, one u32 for
// smem_scalar's a); the output is u32 [1, lanes], or [rows, lanes] for
// the cumsum. What bounds them: launch latency (a few KiB each, a few
// operations a lane), and in the sublane sum and cumsum a chain of 256
// row loads a lane (the sum unrolled, the cumsum 64 rows read ahead of
// their stores, so that the loads are in flight together). So one launch
// runs a batch of probes, all fourteen in run_probes: a CTA a probe (its
// index, inputs, output and rows in the kernel's parameter block), a
// thread a lane; the reference ran a pallas_call each.

#include <stdint.h>

#ifndef SQZ_DEVICE
#define SQZ_DEVICE __device__ __forceinline__
#endif

// the row loops' loads in flight together (a host compiler unrolls on
// its own)
#ifdef __CUDACC__
#define PROBE_UNROLL _Pragma("unroll 16")
#else
#define PROBE_UNROLL
#endif

namespace probe {

constexpr int kProbes = 14;

SQZ_DEVICE uint32_t clz32(uint32_t v) {
#ifdef __CUDA_ARCH__
    return static_cast<uint32_t>(__clz(static_cast<int>(v)));
#else
    return v ? static_cast<uint32_t>(__builtin_clz(v)) : 32u;
#endif
}

// Probe `which` for one lane; returns 0, or -1 for an unknown probe.
SQZ_DEVICE int probe_lane(int which, const void* a_, const void* b_,
                          uint32_t* out, int lanes, int rows, int lane) {
    const uint32_t* a = static_cast<const uint32_t*>(a_);
    const uint32_t* b = static_cast<const uint32_t*>(b_);
    switch (which) {
    case 0: out[lane] = a[lane] << b[lane]; break;
    case 1: out[lane] = a[lane] >> b[lane]; break;
    case 2: out[lane] = clz32(a[lane]); break;
    case 3: out[lane] = a[lane] * b[lane]; break;
    case 4:
        out[lane] = static_cast<uint32_t>(
            (static_cast<uint64_t>(a[lane]) * b[lane]) >> 32);
        break;
    case 5: {
        uint32_t acc = 0;
        PROBE_UNROLL
        for (int r = 0; r < rows; ++r) acc += a[r * lanes + lane];
        out[lane] = acc;
        break;
    }
    case 6: {
        // out may alias a: a block of rows is read before it is written
        constexpr int kRows = 64;
        uint32_t acc = 0;
        for (int r0 = 0; r0 < rows; r0 += kRows) {
            uint32_t v[kRows];
            for (int i = 0; i < kRows; ++i)
                v[i] = r0 + i < rows ? a[(r0 + i) * lanes + lane] : 0u;
            for (int i = 0; i < kRows; ++i)
                if (r0 + i < rows) {
                    acc += v[i];
                    out[(r0 + i) * lanes + lane] = acc;
                }
        }
        break;
    }
    case 7: {
        uint32_t v = a[lane];
        for (int i = 0; i < 10; ++i) v += v;
        out[lane] = v;
        break;
    }
    case 8: out[lane] = a[b[lane] * lanes + lane]; break;
    case 9: {
        const uint32_t num = a[lane], den = b[lane];
        const float inv = 1.0f / static_cast<float>(den);
        uint32_t q = static_cast<uint32_t>(static_cast<float>(num) * inv);
        if (static_cast<int32_t>(num - q * den) < 0) q -= 1;
        if (num - q * den >= den) q += 1;
        out[lane] = q;
        break;
    }
    case 10: out[lane] = static_cast<const uint8_t*>(a_)[lane]; break;
    case 11:
        out[lane] = a[static_cast<const int32_t*>(b_)[0] * lanes + lane];
        break;
    case 12: out[lane] = b[lane] + a[0]; break;
    case 13: {
        const uint64_t v = a[lane];
        out[lane] = static_cast<uint32_t>((v * v) >> 32);
        break;
    }
    default: return -1;
    }
    return 0;
}

// A batch of probes, one launch: item i is CTA i's probe
constexpr int kMaxBatch = 32;
struct Item {
    int which;
    int rows;
    const void* a;
    const void* b;
    uint32_t* out;
};
struct Batch {
    int n;
    int lanes;
    Item item[kMaxBatch];
};

// Lane `lane` of the batch's probe `cta`; returns 0, or -1 for an unknown
// probe.
SQZ_DEVICE int probe_cta(const Batch& batch, int cta, int lane) {
    const Item& it = batch.item[cta];
    return probe_lane(it.which, it.a, it.b, it.out, batch.lanes, it.rows,
                      lane);
}

// The batch of n probes (which, rows, inputs and outputs a probe), or
// false when it is not one the kernel runs (host code).
inline bool make_batch(int n, const int* which, const int* rows,
                       const void* const* a, const void* const* b,
                       void* const* out, int lanes, Batch* batch) {
    if (n < 1 || n > kMaxBatch || lanes < 1 || lanes > 1024) return false;
    batch->n = n;
    batch->lanes = lanes;
    for (int i = 0; i < n; ++i) {
        if (which[i] < 0 || which[i] >= kProbes) return false;
        batch->item[i] = Item{which[i], rows[i], a[i], b[i],
                              static_cast<uint32_t*>(out[i])};
    }
    return true;
}

}  // namespace probe

#ifdef __CUDACC__

__global__ void probe_kernel(const probe::Batch batch) {
    if (static_cast<int>(threadIdx.x) < batch.lanes)
        probe::probe_cta(batch, blockIdx.x, threadIdx.x);
}

// One launch of n probes (item i: probe which[i] in 0..13 of rows[i]
// rows, inputs a[i] and b[i], output out[i]; host arrays of device
// pointers) over `lanes` lanes, a CTA a probe, on `stream`; returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an unknown probe
// or a batch of more than kMaxBatch).
extern "C" int probe_launch(int n, const int* which, const int* rows,
                            const void* const* a, const void* const* b,
                            void* const* out, int lanes, void* stream) {
    probe::Batch batch;
    if (!probe::make_batch(n, which, rows, a, b, out, lanes, &batch))
        return cudaErrorInvalidValue;
    probe_kernel<<<n, lanes, 0, static_cast<cudaStream_t>(stream)>>>(batch);
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
