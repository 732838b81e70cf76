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
// the cumsum. What bounds them: launch latency (a few KiB each); one
// thread per lane, one CTA, a probe index picks the body.

#include <stdint.h>

#ifndef SQZ_DEVICE
#define SQZ_DEVICE __device__ __forceinline__
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
        for (int r = 0; r < rows; ++r) acc += a[r * lanes + lane];
        out[lane] = acc;
        break;
    }
    case 6: {
        uint32_t acc = 0;
        for (int r = 0; r < rows; ++r) {
            acc += a[r * lanes + lane];
            out[r * lanes + lane] = acc;
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

}  // namespace probe

#ifdef __CUDACC__

__global__ void probe_kernel(int which, const void* a, const void* b,
                             uint32_t* out, int lanes, int rows) {
    const int lane = threadIdx.x;
    if (lane < lanes) probe::probe_lane(which, a, b, out, lanes, rows, lane);
}

// One launch of probe `which` (0..13) over `lanes` lanes (one CTA) on
// `stream`; returns the cudaError_t of the launch (cudaErrorInvalidValue
// for an unknown probe).
extern "C" int probe_launch(int which, const void* a, const void* b,
                            void* out, int lanes, int rows, void* stream) {
    if (which < 0 || which >= probe::kProbes) return cudaErrorInvalidValue;
    probe_kernel<<<1, lanes, 0, static_cast<cudaStream_t>(stream)>>>(
        which, a, b, static_cast<uint32_t*>(out), lanes, rows);
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
