// sqz4 block decoder for Hopper (sm_90a).
//
// Replaces the TPU kernel sqz_tpu/ops/sqz4_pallas.py:_decode_kernel
// (launcher _decode_pallas), cold (unseeded) mode.
//
// Input: payload words uint32 [G, Pw, B] (big-endian bytes, zero-padded;
// bytes past Pw * 4 read as zero) and meta int32 [G, 8, B] (row 1 the
// block's original size, row 2 the shared-dictionary length). Output: the
// decoded token records, which the host assembles into bytes:
//   lit  uint32 [G, lw, B]  literal bytes, big-endian four to a word;
//   tok  uint32 [G, tw, B]  token kinds, one bit each, LSB first (1 = match);
//   mrec uint32 [G, mw, B]  match records len << 16 | dist;
//   counts int32 [G, 8, B]  rows optr, nlit, ntok, nmatch, err, steps,
//                           ovf (nmatch > mw), final state.
// Errors (first one sticks; within one step ILSEQ > SIZE > BITS > DIST >
// OVERRUN): a symbol past the model total (ILSEQ), a match length outside
// 2..254 (SIZE), a zero bits count (BITS), a distance past the produced
// bytes plus the dictionary (DIST), output past the block size (OVERRUN),
// and a block still running after t_max steps (ILSEQ).
//
// A step decodes the token grammar two coder ops at a time: op 1 is a
// flag, bits or distance-bit op, op 2 the byte, size or distance-bit op
// that follows it (or nothing when op 1 ended a token). Steps are what
// t_max counts, as in the reference kernel.
//
// What bounds it: as for the encoder, one serial chain per block (divide,
// symbol search, renormalize, state transition) and only as many chains
// as blocks in the call: 512 for 32 MiB of 64 KiB blocks, one thread on
// each of a few warps per SM.
//
// What the design does about it: one thread per block and one per CTA,
// so the blocks spread over every SM and no warp serializes the diverging
// paths of several blocks; native u64 registers and divides; the
// 256-symbol models as Fenwick trees in shared memory (the symbol search
// and the update take log2(256) steps); record streams written straight
// to device memory, so no ring retirement or stream window is needed.

#include "sqz4_coder.cuh"

namespace sqz4 {

// One lane's payload bytes; past `nbytes` the stream reads zeros.
struct ByteSource {
    const uint32_t* in;
    int stride;
    long long nbytes;
    long long pos;
    uint32_t word;

    SQZ_DEVICE uint32_t next() {
        uint32_t b = 0;
        if (pos < nbytes) {
            if ((pos & 3) == 0) word = in[(pos >> 2) * stride];
            b = (word >> (24 - 8 * (pos & 3))) & 0xFF;
        }
        ++pos;
        return b;
    }

    SQZ_DEVICE u64 take(int k) {
        u64 v = 0;
        for (int i = 0; i < k; ++i) v = (v << 8) | next();
        return v;
    }
};

struct RangeDecoder {
    u64 low, rng, code, rd;
    ByteSource src;

    // Underflow escape, divide, and the cumulative count of the next
    // symbol (saturated at total - 1). *bad: the count lies past total.
    SQZ_DEVICE int front(int total, bool* bad) {
        const u64 tot = static_cast<u64>(total);
        if (rng < tot) {
            code = (code << 16) | src.take(2);
            low <<= 16;
            rng = ~low;
        }
        rd = rng / tot;
        const u64 diff = code - low;
        *bad = diff >= tot * rd;
        return *bad ? total - 1 : static_cast<int>(diff / rd);
    }

    // Narrow the interval to [start, start + size) and renormalize.
    SQZ_DEVICE void back(int start, int size) {
        low += static_cast<u64>(start) * rd;
        rng = static_cast<u64>(size) * rd;
        const int cnt = lead_zero_bytes(low ^ (low + rng));
        if (cnt >= 8) {
            code = src.take(8);
            low = 0;
            rng = 0;
        } else if (cnt) {
            code = (code << (8 * cnt)) | src.take(cnt);
            low <<= 8 * cnt;
            rng <<= 8 * cnt;
        }
    }

    // One binary-model op: frequencies *f0 / *f1, updated after coding.
    SQZ_DEVICE int binary(int* f0, int* f1, bool* bad) {
        const int cum = front(*f0 + *f1, bad);
        const int sym = cum >= *f0;
        back(sym ? *f0 : 0, sym ? *f1 : *f0);
        *(sym ? f1 : f0) += 1;
        return sym;
    }

    // One op of a 256-symbol model, updated after coding.
    SQZ_DEVICE int model(Model256 md, bool* bad) {
        const int cum = front(md.total(), bad);
        int start;
        const int sym = md.search(cum, &start);
        back(start, md.size(sym));
        md.bump(sym);
        return sym;
    }

    // One op of an n-entry csum model, updated after coding.
    SQZ_DEVICE int table(int* c, int stride, int n, bool* bad) {
        const int cum = front(c[(n - 1) * stride], bad);
        const int sym = csum_search(c, stride, n, cum);
        int start, size, total;
        csum_stats(c, stride, n, sym, &start, &size, &total);
        back(start, size);
        csum_bump(c, stride, sym, n);
        return sym;
    }
};

// Decode one block. Pointers are offset to the lane; rows of every array
// are `lanes` elements apart.
SQZ_DEVICE void decode_lane(const uint32_t* payload, int pw,
                            const int32_t* meta, int lanes, int t_max,
                            uint32_t* lit, int lw, uint32_t* tok, int tw,
                            uint32_t* mrec, int mw, int32_t* counts,
                            int* tab, int stride) {
    init_tables(tab, stride);
    const int sizes = meta[1 * lanes], dlen = meta[2 * lanes];
    RangeDecoder dec{0, ~0ull, 0, 0,
                     ByteSource{payload, lanes, 4ll * pw, 0, 0u}};
    dec.code = dec.src.take(8);

    int state = kFlag, psize = 0, pbits = 0, pdist = 0, bitpos = 0;
    int optr = 0, nlit = 0, ntok = 0, nmatch = 0, err = 0, t = 0;
    uint32_t litw = 0, tokw = 0;
    for (; t < t_max && state < kDone; ++t) {
        // ---- op 1: flag | bits | distance bit
        bool bad1 = false;
        const bool o1_flag = state == kFlag, o1_bits = state == kBitsState;
        int sym1;
        if (o1_flag) {
            sym1 = dec.binary(tab + kLit * stride, tab + (kLit + 1) * stride,
                              &bad1);
        } else if (o1_bits) {
            sym1 = dec.table(tab + kBits * stride, stride, 32, &bad1);
            pbits = sym1;
            pdist = 0;
            bitpos = 0;
        } else {
            sym1 = dec.binary(tab + (kDist0 + bitpos) * stride,
                              tab + (kDist1 + bitpos) * stride, &bad1);
            pdist |= sym1 << bitpos;
            ++bitpos;
        }
        const bool bad_bits = o1_bits && sym1 == 0;
        const bool done1 = (o1_bits && sym1 == 1)
                           || (state == kDistState && bitpos == pbits - 1);
        const bool emit1 = !bad1 && done1;
        const bool o2_byte = !bad1 && o1_flag && sym1 == 1;
        const bool o2_size = !bad1 && o1_flag && sym1 == 0;
        const bool o2_dist = !bad1 && !bad_bits && !o1_flag && !done1;

        // ---- op 2: byte | size | distance bit | nothing
        bool bad2 = false;
        int sym2 = 0;
        if (o2_byte || o2_size) {
            sym2 = dec.model(model256(tab, stride, o2_byte), &bad2);
        } else if (o2_dist) {
            sym2 = dec.binary(tab + (kDist0 + bitpos) * stride,
                              tab + (kDist1 + bitpos) * stride, &bad2);
        }

        // ---- token outputs
        const bool lit_over = o2_byte && optr >= sizes;
        if (o2_byte) {
            litw |= static_cast<uint32_t>(sym2) << (24 - 8 * (nlit & 3));
            if ((nlit & 3) == 3) {
                if ((nlit >> 2) < lw)
                    lit[static_cast<long long>(nlit >> 2) * lanes] = litw;
                litw = 0;
            }
            ++nlit;
            ++optr;
        }
        const bool eos = o2_size && sym2 == 255;
        const bool bad_size = o2_size && !eos && (sym2 < 2 || sym2 > 254);
        if (o2_size && !eos) psize = sym2;
        bool done2 = false;
        if (o2_dist) {
            pdist |= sym2 << bitpos;
            ++bitpos;
            done2 = bitpos == pbits - 1 && !bad2;
        }
        const bool emit = emit1 || done2;
        const int dist = pdist | (emit ? 1 << (pbits > 0 ? pbits - 1 : 0) : 0);
        const bool bad_dist = emit && dist > optr + dlen;
        const bool over = emit && optr + psize > sizes;
        const bool emit_ok = emit && !bad_dist && !over;
        if (emit_ok) {
            if (nmatch < mw)
                mrec[static_cast<long long>(nmatch) * lanes] =
                    (static_cast<uint32_t>(psize) << 16)
                    | static_cast<uint32_t>(dist);
            ++nmatch;
            optr += psize;
            tokw |= 1u << (ntok & 31);
        }
        if (o2_byte || emit_ok) {
            ++ntok;
            if ((ntok & 31) == 0) {
                if ((ntok >> 5) - 1 < tw)
                    tok[static_cast<long long>((ntok >> 5) - 1) * lanes] = tokw;
                tokw = 0;
            }
        }

        // ---- next state and errors
        int nstate = state;
        if (o2_byte) nstate = kFlag;
        if (o2_size) nstate = eos ? kDone : kBitsState;
        if (o2_dist) nstate = done2 ? kFlag : kDistState;
        if (emit1) nstate = kFlag;
        const int newerr = (bad1 || bad2) ? kEIlseq
                         : bad_size ? kESize
                         : bad_bits ? kEBits
                         : bad_dist ? kEDist
                         : (lit_over || over) ? kEOverrun : 0;
        if (newerr) {
            if (!err) err = newerr;
            nstate = kErr;
        }
        state = nstate;
    }

    if ((nlit & 3) && (nlit >> 2) < lw)
        lit[static_cast<long long>(nlit >> 2) * lanes] = litw;
    if ((ntok & 31) && (ntok >> 5) < tw)
        tok[static_cast<long long>(ntok >> 5) * lanes] = tokw;
    counts[0 * lanes] = optr;
    counts[1 * lanes] = nlit;
    counts[2 * lanes] = ntok;
    counts[3 * lanes] = nmatch;
    counts[4 * lanes] = (err == 0 && state < kDone) ? kEIlseq : err;
    counts[5 * lanes] = t;
    counts[6 * lanes] = nmatch > mw;
    counts[7 * lanes] = state;
}

}  // namespace sqz4

#ifdef __CUDACC__

__global__ void sqz4_decode_kernel(const uint32_t* __restrict__ payload,
                                   const int32_t* __restrict__ meta,
                                   int n_lanes, int pw, int lanes, int t_max,
                                   uint32_t* __restrict__ lit, int lw,
                                   uint32_t* __restrict__ tok, int tw,
                                   uint32_t* __restrict__ mrec, int mw,
                                   int32_t* __restrict__ counts) {
    extern __shared__ int smem[];
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= n_lanes) return;
    const long long g = n / lanes, b = n % lanes;
    sqz4::decode_lane(payload + g * pw * lanes + b, pw,
                      meta + g * 8 * lanes + b, lanes, t_max,
                      lit + g * lw * lanes + b, lw,
                      tok + g * tw * lanes + b, tw,
                      mrec + g * mw * lanes + b, mw,
                      counts + g * 8 * lanes + b, smem + threadIdx.x,
                      blockDim.x);
}

// payload: [groups, pw, lanes] u32; meta: [groups, 8, lanes] i32; lit,
// tok, mrec: [groups, lw | tw | mw, lanes] u32; counts: [groups, 8, lanes]
// i32. Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int sqz4_decode_launch(const void* payload, const void* meta,
                                  int groups, int pw, int lanes, int t_max,
                                  void* lit, int lw, void* tok, int tw,
                                  void* mrec, int mw, void* counts,
                                  int threads, void* stream) {
    const int n_lanes = groups * lanes;
    const size_t smem = sizeof(int) * sqz4::kTableWords * threads;
    cudaError_t err = cudaFuncSetAttribute(
        sqz4_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int ctas = (n_lanes + threads - 1) / threads;
    sqz4_decode_kernel<<<ctas, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(payload),
        static_cast<const int32_t*>(meta), n_lanes, pw, lanes, t_max,
        static_cast<uint32_t*>(lit), lw, static_cast<uint32_t*>(tok), tw,
        static_cast<uint32_t*>(mrec), mw, static_cast<int32_t*>(counts));
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
