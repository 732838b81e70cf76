// sqz4 block decoder for Hopper (sm_90a).
//
// Replaces the TPU kernel sqz_tpu/ops/sqz4_pallas.py:_decode_kernel
// (launcher _decode_pallas) in both its modes: cold, and seeded
// (seeded=True, _decode_pallas(seed_tab=)), where every block of the
// launch starts its models from one warm seed (sqz4_chain.cuh kSeed*, the
// anchor block's final rescaled state, FORMAT.md §3.1) and a match may
// reach back into the shared dictionary (meta row 2 bytes before the
// block; the host's assembly prepends them). A seeded launch takes the
// seed as one column of kSeedWords int32 words; a cold launch passes a
// null seed. Only the models' start differs: the reciprocal windows
// (DecRcp) are filled at each model's starting total, whatever it is.
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
// Block sizes: any block up to 2^kMaxBlockBits bytes (sqz4_div.cuh), so
// the route above 64 KiB blocks decodes here too (the counterpart there of
// the reference's scan decoder, sqz_tpu/ops/sqz4_jax.py:_decode_scan).
// The models' counts and the reciprocal windows' totals are int32 / u32
// and every total stays below kTotalLimit, where recip64 is exact; the
// step budget t_max = 9 * bs + 64 and the step counter are uint32 (at
// 2^28 bytes the budget is 2,415,919,168, past int32), the stream
// positions and the other counts int32 and the array offsets 64-bit;
// counts row 5 holds the steps' low 32 bits; a match record keeps len << 16 | dist, the distance bounded by
// the window (2^15), not by the block. The underflow escape (ChainDecoder
// ::front) fires about once in 2^56 / total symbols, so more often as
// totals grow; tests/test_torch_csrc_host.py reaches it from crafted
// coder states.
//
// A step decodes the token grammar two coder ops at a time: op 1 is a
// flag, bits or distance-bit op, op 2 the byte, size or distance-bit op
// that follows it (or nothing when op 1 ended a token). Steps are what
// t_max counts, as in the reference kernel.
//
// What bounds it: each block is one serial chain (divide, symbol test,
// interval update, renormalize, state transition, op after op; the next
// op's model depends on this op's symbol), and a launch holds one chain
// per block: 512 for 32 MiB of 64 KiB blocks, on 132 SMs. The time is the
// symbols of the longest block times the latency of one step. The
// one-thread design before this one spent ~1,600 cycles a symbol: two
// software u64 divides (rng / total, then diff / rd for the cumulative
// count), a Fenwick search of eight dependent loads, and payload loads
// inside the renormalization.
//
// What the design does about it (ChainDecoder below, sqz4_chain.cuh):
//   - the divide by a model total is a high multiply by the model's
//     reciprocal and a remainder test (sqz4_div.cuh). A model's total
//     grows by one an update, so each model keeps the reciprocals of a
//     window of 32 totals in shared memory, which the warp's 32 lanes
//     compute at once as the total enters it (rcp_fill): one
//     reciprocal's latency in 32 updates, where computing one at each
//     update put ~200 cycles of fp64 and conversion latency behind every
//     symbol (PERF.md). The reciprocal of each model's current total
//     waits in registers (DecRcp), read from the window right after the
//     update, so no load sits between a model's counts and the divide.
//     No `/` is left in this kernel.
//   - no second divide: a symbol is found in the scaled domain. A binary
//     op (flags and distance bits, 86% of the symbols of pseudo-text)
//     decodes with one multiply and a compare, sym = diff >= f0 * rd; the
//     bits table and the 256-symbol models compare diff against their
//     starts times rd. The models live in the lanes' registers
//     (LaneModels, sqz4_chain.cuh): a 256-symbol search is eight
//     compares a lane and a warp sum where a Fenwick tree in shared
//     memory needs eight dependent loads, and an update is a predicated
//     add a lane.
//   - the payload column comes into shared memory kStage words at a time,
//     loaded by the warp's lanes a chunk ahead (Stager), and into a
//     64-bit byte cache one word ahead of the renormalization that reads
//     it (ByteReader).
//   - launch geometry: one block per CTA, a warp per block whose 32 lanes
//     compute the same chain (one lane stores): the blocks spread over
//     every SM and no warp serializes the diverging paths of several
//     blocks (one block per CTA measured 4.4x faster than 32). Half
//     as many blocks a launch took as long (PERF.md): no two chains
//     share a scheduler.
//   - the divide's correction runs beside the products it selects
//     between (a binary op's f0 * rd and total * rd for both quotients).
// What bounds it now: the chain of each step, whose next model and op
// depend on the symbol just decoded: the divide, the symbol test, the
// renormalization, the state machine's branches and the record stores,
// ~685 SM cycles a symbol on pseudo-text (PERF.md has the variants that
// split it). A second warp cannot take the models' work as in the token
// encoder: the decoder learns each op only from the symbol before it.
// Corrupt lanes keep the reference's step grammar, t_max budget, error
// priority and counts (the scaled tests saturate as the reference's
// cumulative count does).

#include "sqz4_chain.cuh"

namespace sqz4 {

// reciprocal slots of the models' totals
constexpr int kRcpLit = 0, kRcpDist = 1, kRcpBits = 33, kRcpByte = 34,
              kRcpSize = 35, kRcpSlots = 36;

struct DecSmem {
    // each model's reciprocals of the 32 totals of the aligned window
    // holding its total: total t's at rcp[slot][t % 32]
    u64 rcp[kRcpSlots][32];
    uint32_t stage[2 * kStage];   // the payload column, staged
};

// The reciprocals of a window's 32 totals, the warp's lanes side by side.
SQZ_DEVICE void rcp_fill(DecSmem* sm, int slot, uint32_t tot) {
    warp_sync();
    for (int i = lane_id(); i < 32; i += kLanes)
        sm->rcp[slot][i] = recip64((tot & ~31u) + i);
    warp_sync();
}

// The reciprocal of model `slot`'s new total tot, read right after the
// model's update: its next use is at least one op later, so the load is
// off the chain. A total grows by one an update: the window is refilled
// as the total enters it, once in 32 updates.
SQZ_DEVICE u64 rcp_next(DecSmem* sm, int slot, uint32_t tot) {
    if ((tot & 31) == 0) rcp_fill(sm, slot, tot);
    return sm->rcp[slot][tot & 31];
}

// The reciprocal of model `slot`'s starting total tot, its window filled.
SQZ_DEVICE u64 rcp_start(DecSmem* sm, int slot, uint32_t tot) {
    rcp_fill(sm, slot, tot);
    return sm->rcp[slot][tot & 31];
}

// The reciprocals of every model's current total, in registers: one each
// for the literal flag, bits, byte and size models (the same on every
// lane), and the distance-bit models' spread over the lanes as their
// counts are (LaneBinary).
struct DecRcp {
    static constexpr int kPer = LaneBinary<32>::kPer;
    u64 lit, bits, byte, size;
    u64 dist[kPer];

    // every model's window at its starting total: cold, the fresh totals
    // 2, 32 and 256 (the cold kernel's code); seeded, a warm seed's (up to
    // 2^14), which differs from one distance-bit model to the next
    SQZ_DEVICE void init(DecSmem* sm, const LaneModels& md, bool seeded) {
        if (!seeded) {
            for (int k = 0; k < kRcpSlots; ++k)
                rcp_fill(sm, k,
                         k == kRcpBits ? 32u : k >= kRcpByte ? 256u : 2u);
            lit = sm->rcp[kRcpLit][2];
            bits = sm->rcp[kRcpBits][0];
            byte = sm->rcp[kRcpByte][0];
            size = sm->rcp[kRcpSize][0];
            SQZ_UNROLL()
            for (int q = 0; q < kPer; ++q) dist[q] = sm->rcp[kRcpDist][2];
            return;
        }
        lit = rcp_start(sm, kRcpLit, md.lit0 + md.lit1);
        bits = rcp_start(sm, kRcpBits, md.bits.total);
        byte = rcp_start(sm, kRcpByte, md.byte.total);
        size = rcp_start(sm, kRcpSize, md.size.total);
        SQZ_UNROLL()
        for (int q = 0; q < kPer; ++q) dist[q] = 0;
        for (int i = 0; i < 32; ++i) {
            int a, b;
            md.dist.get(i, &a, &b);
            const u64 m = rcp_start(sm, kRcpDist + i, a + b);
            SQZ_UNROLL()
            for (int q = 0; q < kPer; ++q)
                dist[q] = lane_id() * kPer + q == i ? m : dist[q];
        }
    }

    // distance-bit model i's
    SQZ_DEVICE u64 get_dist(int i) const {
        u64 v = 0;
        SQZ_UNROLL()
        for (int q = 0; q < kPer; ++q) v |= dist[q] & (0ull - (q == i % kPer));
        const int o = i / kPer;
        return (static_cast<u64>(static_cast<uint32_t>(
                    shfl(static_cast<int>(v >> 32), o))) << 32)
               | static_cast<uint32_t>(shfl(static_cast<int>(v), o));
    }

    // after distance-bit model i's update to total tot
    SQZ_DEVICE void next_dist(DecSmem* sm, int i, uint32_t tot) {
        const u64 m = rcp_next(sm, kRcpDist + i, tot);
        SQZ_UNROLL()
        for (int q = 0; q < kPer; ++q)
            dist[q] = lane_id() * kPer + q == i ? m : dist[q];
    }
};

struct ChainDecoder {
    u64 low, rng, code;
    ByteReader src;

    // Underflow escape, then the divide's estimate: returns mulhi64(rng,
    // m) (m the reciprocal of tot), rng / tot or one less, and *diff =
    // code - low.
    SQZ_DEVICE u64 front(uint32_t tot, u64 m, u64* diff) {
        if (rng < tot) {   // rare: re-inflate the range
            code = (code << 16) | src.take(2);
            low <<= 16;
            rng = ~low;
        }
        *diff = code - low;
        return mulhi64(rng, m);
    }

    // Narrow the interval to [low + add, low + add + rg) and renormalize
    // (eight settled bytes: the reference's code reload, low = rng = 0).
    SQZ_DEVICE void back(u64 add, u64 rg) {
        low += add;
        rng = rg;
        const int cnt = lead_zero_bytes(low ^ (low + rng));
        if (cnt) {   // most ops settle no byte
            code = shl(code, 8 * cnt) | src.take(cnt);
            low = shl(low, 8 * cnt);
            rng = shl(rng, 8 * cnt);
        }
    }

    // One binary-model op with counts a, b (m the reciprocal of a + b);
    // the caller updates the model.
    SQZ_DEVICE int binary(int a, int b, u64 m, bool* bad) {
        const uint32_t tot = static_cast<uint32_t>(a + b);
        u64 diff;
        const u64 re = front(tot, m, &diff);
        // rd = rng / tot is re or re + 1: the products for both go on
        // while the remainder test decides
        const bool up = div_up(rng, tot, re);
        const u64 ae = static_cast<u64>(a) * re, te = tot * re;
        const u64 f0rd = up ? ae + a : ae, totrd = up ? te + tot : te;
        const int sym = diff >= f0rd;
        *bad = diff >= totrd;
        back(sym ? f0rd : 0ull, sym ? totrd - f0rd : f0rd);
        return sym;
    }

    // One op of a multi-symbol model (the 256-symbol byte and size
    // models, the 32-entry bits model; *m the reciprocal of its total),
    // updated after coding, *m with it.
    template <int N>
    SQZ_DEVICE int search(DecSmem* sm, LaneModel<N>& md, int slot, u64* m,
                          bool* bad) {
        const uint32_t tot = static_cast<uint32_t>(md.total);
        u64 diff;
        const u64 re = front(tot, *m, &diff);
        const u64 rd = re + div_up(rng, tot, re);
        *bad = diff >= tot * rd;
        int start, size;
        const int sym = md.search(diff, rd, &start, &size);
        back(static_cast<u64>(start) * rd, static_cast<u64>(size) * rd);
        md.bump(sym);
        *m = rcp_next(sm, slot, tot + 1);
        return sym;
    }
};

// Decode one block, its models started from `seed` (kSeed* layout) or,
// where it is null, cold. Pointers are offset to the lane; rows of every
// array are `lanes` elements apart. Every lane of the warp decodes the
// same block; lane 0 stores.
SQZ_DEVICE void decode_lane(const uint32_t* payload, int pw,
                            const int32_t* meta, int lanes, uint32_t t_max,
                            const int32_t* seed, uint32_t* lit, int lw,
                            uint32_t* tok, int tw, uint32_t* mrec, int mw,
                            int32_t* counts, DecSmem* sm) {
    LaneModels md;
    md.init(seed);
    DecRcp rc;
    rc.init(sm, md, seed != nullptr);
    const bool st = lane_id() == 0;
    const int sizes = meta[1 * lanes], dlen = meta[2 * lanes];
    ChainDecoder dec{0, ~0ull, 0, ByteReader{}};
    dec.src.init(payload, lanes, pw, sm->stage);
    dec.code = dec.src.take(8);

    int state = kFlag, psize = 0, pbits = 0, pdist = 0, bitpos = 0;
    int optr = 0, nlit = 0, ntok = 0, nmatch = 0, err = 0;
    uint32_t t = 0, litw = 0, tokw = 0;
    for (; t < t_max && state < kDone; ++t) {
        // ---- op 1: flag | bits | distance bit
        bool bad1 = false;
        const bool o1_flag = state == kFlag, o1_bits = state == kBitsState;
        int sym1;
        if (o1_bits) {
            sym1 = dec.search(sm, md.bits, kRcpBits, &rc.bits, &bad1);
            pbits = sym1;
            pdist = 0;
            bitpos = 0;
        } else if (o1_flag) {
            sym1 = dec.binary(md.lit0, md.lit1, rc.lit, &bad1);
            md.lit0 += !sym1;
            md.lit1 += sym1;
            rc.lit = rcp_next(sm, kRcpLit, md.lit0 + md.lit1);
        } else {
            int a, b;
            md.dist.get(bitpos, &a, &b);
            sym1 = dec.binary(a, b, rc.get_dist(bitpos), &bad1);
            md.dist.bump(bitpos, sym1);
            rc.next_dist(sm, bitpos, a + b + 1);
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
        if (o2_byte) {
            sym2 = dec.search(sm, md.byte, kRcpByte, &rc.byte, &bad2);
        } else if (o2_size) {
            sym2 = dec.search(sm, md.size, kRcpSize, &rc.size, &bad2);
        } else if (o2_dist) {
            int a, b;
            md.dist.get(bitpos, &a, &b);
            sym2 = dec.binary(a, b, rc.get_dist(bitpos), &bad2);
            md.dist.bump(bitpos, sym2);
            rc.next_dist(sm, bitpos, a + b + 1);
        }

        // ---- token outputs
        const bool lit_over = o2_byte && optr >= sizes;
        if (o2_byte) {
            litw |= static_cast<uint32_t>(sym2) << (24 - 8 * (nlit & 3));
            if ((nlit & 3) == 3) {
                if (st && (nlit >> 2) < lw)
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
            if (st && nmatch < mw)
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
                if (st && (ntok >> 5) - 1 < tw)
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

    if (!st) return;
    if ((nlit & 3) && (nlit >> 2) < lw)
        lit[static_cast<long long>(nlit >> 2) * lanes] = litw;
    if ((ntok & 31) && (ntok >> 5) < tw)
        tok[static_cast<long long>(ntok >> 5) * lanes] = tokw;
    counts[0 * lanes] = optr;
    counts[1 * lanes] = nlit;
    counts[2 * lanes] = ntok;
    counts[3 * lanes] = nmatch;
    counts[4 * lanes] = (err == 0 && state < kDone) ? kEIlseq : err;
    counts[5 * lanes] = static_cast<int32_t>(t);
    counts[6 * lanes] = nmatch > mw;
    counts[7 * lanes] = state;
}

}  // namespace sqz4

#ifdef __CUDACC__

// One block per CTA of 32 threads. kSeeded: the seeded mode; the cold
// instantiation starts every block's models cold at compile time, so it
// holds the cold code alone.
template <bool kSeeded>
__global__ void __launch_bounds__(32)
sqz4_decode_kernel(const uint32_t* __restrict__ payload,
                                   const int32_t* __restrict__ meta,
                                   int pw, int lanes, uint32_t t_max,
                                   const int32_t* __restrict__ seed,
                                   uint32_t* __restrict__ lit, int lw,
                                   uint32_t* __restrict__ tok, int tw,
                                   uint32_t* __restrict__ mrec, int mw,
                                   int32_t* __restrict__ counts) {
    __shared__ sqz4::DecSmem sm;
    const int n = blockIdx.x;
    const long long g = n / lanes, b = n % lanes;
    sqz4::decode_lane(payload + g * pw * lanes + b, pw,
                      meta + g * 8 * lanes + b, lanes, t_max,
                      kSeeded ? seed : nullptr,
                      lit + g * lw * lanes + b, lw,
                      tok + g * tw * lanes + b, tw,
                      mrec + g * mw * lanes + b, mw,
                      counts + g * 8 * lanes + b, &sm);
}

// payload: [groups, pw, lanes] u32; meta: [groups, 8, lanes] i32; lit,
// tok, mrec: [groups, lw | tw | mw, lanes] u32; counts: [groups, 8, lanes]
// i32. seed: null (cold) or kSeedWords i32 (every block starts warm from
// it). t_max: the step budget, unsigned. threads: 32 (a warp per block). Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int sqz4_decode_launch(const void* payload, const void* meta,
                                  int groups, int pw, int lanes,
                                  unsigned t_max,
                                  void* lit, int lw, void* tok, int tw,
                                  void* mrec, int mw, void* counts,
                                  const void* seed, int threads,
                                  void* stream) {
    if (threads != 32) return static_cast<int>(cudaErrorInvalidValue);
    const int n_lanes = groups * lanes;
    if (n_lanes == 0) return static_cast<int>(cudaSuccess);
    const auto kernel =
        seed ? sqz4_decode_kernel<true> : sqz4_decode_kernel<false>;
    kernel<<<n_lanes, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(payload),
        static_cast<const int32_t*>(meta), pw, lanes, t_max,
        static_cast<const int32_t*>(seed), static_cast<uint32_t*>(lit), lw,
        static_cast<uint32_t*>(tok), tw, static_cast<uint32_t*>(mrec), mw,
        static_cast<int32_t*>(counts));
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
