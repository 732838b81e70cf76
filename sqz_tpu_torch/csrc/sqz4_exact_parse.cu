// sqz4 exact LZ parse for Hopper (sm_90a): each block's greedy parse and
// its micro-op stream, the input of the per-op model statistics
// (csrc/sqz4_model_stats.cu), made on the card.
//
// Replaces no Pallas kernel. It replaces the host planner of the route
// above 64 KiB blocks (sqz_tpu/ops/sqz4_jax.py encode_blocks, through the
// native sqz4_plan_pack): host threads walk each block's greedy parse
// with a 2-byte hash chain of no depth limit. At 10^8 B of text in 1 MiB
// blocks that took about 3.4 s of a 3.5-s compress on an H100's host,
// the card idle.
//
// What it computes, lane b's bytes data[offsets[b], + lengths[b]) (lanes
// 1+ after the history bytes data[hist_off, + hist_len), as the warm
// pass's blocks 1+ after block 0's tail, FORMAT.md §3.1): the native
// planner's op stream exactly. Its find(i) walks a chain that holds every
// earlier position, newest first, takes a candidate only when strictly
// longer, and stops at the cap; so it returns, of every j in
// [max(0, i - window + 1), i), the longest match of at least 2 bytes
// capped at min(254, n - i), and of the longest the nearest. The hash
// and its pre-tests only prune. Here every window position is a
// candidate, and a CTA-wide max of the key (length << 16) | (j - lo)
// picks the same one (key length < 2: a literal). Then the host's rules:
// a match of 3 bytes or fewer whose distance needs more than 3 bits is a
// literal; a match emits 0,0 / 1,len / 3,nbits / 4+k,bit k (k < nbits -
// 1), a literal 0,1 / 2,byte, the block's end 0,0 / 1,0xFF and eight
// flushes 254,0; without lz every byte is a literal.
//
// Output: m_words / s_words uint32 [n, rows], lane b's ops in row b,
// four big-endian ops a word, pads m 0xFF and s 0 to the row's end (as
// the native planner pre-fills them), and counts int64 [n], lane b's
// ops (the words past `rows` are not written; the caller checks).
//
// The design, one CTA of kParseThreads threads a lane:
// - the lane's stream (history, then the block) is staged in dynamic
//   shared memory: the window behind the cursor and kAhead bytes ahead.
//   When a find would read past the buffer, the kept bytes move to its
//   front (through registers, a round of the CTA at a time) and the next
//   bytes come from device memory, so each byte is read from it once;
// - a find scans the window sixteen candidates (a 16-byte group) a
//   thread at a time, the groups handed out downwards from the cursor:
//   one 16-byte and one 4-byte load, funnel shifts and a zero-byte test
//   a word against the cursor's first two bytes. Only a group with a
//   2-byte match (or at the window's ends) goes on: its candidates'
//   lengths up to 4 from two more funnel shifts. A candidate of 2 or 3
//   bytes is done; one of 4 or more is queued in its warp's list (a warp
//   scan of the lanes' counts places them), and when the scan is over
//   the warp's lanes extend the list's candidates side by side, 8 bytes
//   a step, up to the cap, each only if it can still beat the best key
//   the warp knows (a candidate farther than the best needs a longer
//   match, a nearer one an equal one: one byte at that length rejects
//   most). A full list leaves the rest to their lanes;
// - the warps' maxima meet in shared memory (a double buffer, so a fast
//   warp never overwrites what a slow one still reads) behind one CTA
//   barrier a find, and every thread takes their max;
// - tokens (a match's length and distance, a literal's byte) queue in
//   shared memory, one a thread; a full queue is expanded by the CTA
//   together: each thread its token's ops, placed by a CTA scan of the
//   op counts into a byte staging area, then written out a word a thread.
//
// What bounds it: the finds, one after another in each lane. A find
// reads the whole window from shared memory (2,048 groups at a 32 KiB
// window): about 3,300 SM cycles on an H100 where no candidate goes on
// (random bytes, a find a byte: about 1,000,000 finds a 1 MiB block).
// Text costs about 52,800 finds a 1 MiB block, but each has some 500
// candidates of 2 bytes, 300 of 4, and on those the extensions cost
// about twice the scan. The bytes (each read once, the op words written
// once) are far below it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace sqz4 {

constexpr int kParseThreads = 1024;
constexpr int kParseWarps = kParseThreads / 32;
constexpr int kMinMatch = 2;
constexpr int kMaxMatch = 254;
// bytes a find reads past the cursor: the cap and three words of the last
// unaligned 8-byte load
constexpr int kReach = kMaxMatch + 16;
constexpr int kAhead = 64 * 1024;    // bytes staged ahead of the window
constexpr int kMaxWindow = 1 << 16;  // (j - lo) fills the key's low half
constexpr int kTokenOps = 3 + 15;    // a match at a 16-bit distance
constexpr uint32_t kEos = 0xFFFFFFFFu;
// a flush's staging bytes: three carried ops, a full queue, a word of pad
constexpr int kStage = (3 + kParseThreads * kTokenOps + 4 + 15) & ~15;
constexpr int kMoveWords = 4;        // uint4 a thread a round of a move
constexpr int kListCap = 256;        // long candidates a warp queues a find

__host__ __device__ constexpr int buffer_bytes(int window) {
    return ((window + kReach + 16 + 15) & ~15) + kAhead;
}

__host__ __device__ constexpr int smem_bytes(int window) {
    return buffer_bytes(window) + 2 * kStage
           + 4 * (kParseThreads + 64 + 64) + 2 * kParseWarps * kListCap;
}

// byte p of the lane's stream: the history, then the block
__device__ __forceinline__ uint8_t stream_byte(const uint8_t* data,
                                               long long hoff, int hlen,
                                               long long off, int p) {
    return p < hlen ? data[hoff + p] : data[off + (p - hlen)];
}

// 0x80 in each byte of z that is zero, else 0 (exact: no borrow)
__device__ __forceinline__ uint32_t zero_bytes(uint32_t z) {
    return ~(((z & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | z | 0x7F7F7F7Fu);
}

// nonzero iff z has a zero byte (which bytes, only below the lowest)
__device__ __forceinline__ uint32_t any_zero_byte(uint32_t z) {
    return (z - 0x01010101u) & ~z & 0x80808080u;
}

// the 4 bytes at buffer offset u, the first in the low byte
__device__ __forceinline__ uint32_t word_at(const uint32_t* buf, int u) {
    return __funnelshift_r(buf[u >> 2], buf[(u >> 2) + 1], (u & 3) * 8);
}

// the 8 bytes at buffer offset u, the first in the low byte
__device__ __forceinline__ uint64_t bytes8_at(const uint32_t* buf, int u) {
    const int w = u >> 2, sh = (u & 3) * 8;
    const uint32_t x0 = buf[w], x1 = buf[w + 1], x2 = buf[w + 2];
    return (static_cast<uint64_t>(__funnelshift_r(x1, x2, sh)) << 32)
           | __funnelshift_r(x0, x1, sh);
}

// a match's common length from k (the first k bytes equal), capped
__device__ __forceinline__ int extend(const uint32_t* buf, int jb, int ib,
                                      int k, int cap) {
    while (k < cap) {
        const uint64_t d = bytes8_at(buf, jb + k) ^ bytes8_at(buf, ib + k);
        if (d)
            return min(cap, k + ((__ffsll(static_cast<long long>(d)) - 1)
                                 >> 3));
        k += 8;
    }
    return cap;
}

// 0x80 in byte k of the word at buffer offset base where la <= base + k
// < ib: the candidates inside the window
__device__ __forceinline__ uint32_t range_mask(int base, int la, int ib) {
    const int lo_k = la - base, hi_k = ib - base;
    uint32_t m = 0x80808080u;
    if (lo_k > 0) m = lo_k >= 4 ? 0 : m << (8 * lo_k);
    if (hi_k < 4) m = hi_k <= 0 ? 0 : m & (0x80808080u >> (8 * (4 - hi_k)));
    return m;
}

// A candidate at buffer offset jb that matches 4 bytes or more (d its
// key's low half, the cap above 4): extended, 8 bytes a step, if it can
// still beat the best key this thread knows, which it then raises. A
// candidate farther than the best needs a longer match, a nearer one an
// equal one: one byte at that length rejects most.
__device__ __forceinline__ void take_long(int jb, uint32_t d, int ib, int cap,
                                          const uint32_t* buf,
                                          uint32_t& best) {
    const uint8_t* bufc = reinterpret_cast<const uint8_t*>(buf);
    const int need = max(kMinMatch, static_cast<int>(best >> 16)
                                        + (d > (best & 0xFFFF) ? 0 : 1));
    if (need > cap
        || (need > 4 && bufc[jb + need - 1] != bufc[ib + need - 1]))
        return;
    const int l = extend(buf, jb, ib, 4, cap);
    if (l >= need) best = (static_cast<uint32_t>(l) << 16) | d;
}

struct Lane {
    uint32_t* m_out;    // the lane's row
    uint32_t* s_out;
    long long rows;
    long long ops;      // ops written so far
};

// The CTA's exclusive scan of v (one value a thread): returns v's offset,
// *total the sum.
__device__ __forceinline__ int cta_exscan(int v, int* wsum, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int w = lane < kParseWarps ? wsum[lane] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, w, d);
            if (lane >= d) w += y;
        }
        wsum[32 + lane] = w;
    }
    __syncthreads();
    *total = wsum[32 + kParseWarps - 1];
    return x - v + (warp ? wsum[32 + warp - 1] : 0);
}

// Expand the queue's ntok tokens into ops and write their whole words;
// the last (final) flush pads the stream's last word and the row.
__device__ void flush(const uint32_t* tokq, int ntok, bool final,
                      uint8_t* stm, uint8_t* sts, int* wsum, Lane& ln) {
    __syncthreads();   // the queue is full, the last staging read done
    const int tid = threadIdx.x;
    uint32_t tok = 0;
    int nops = 0, nbits = 0;
    if (tid < ntok) {
        tok = tokq[tid];
        if (tok == kEos) {
            nops = 10;
        } else if (tok >> 16) {
            nbits = 32 - __clz(tok & 0xFFFF);
            nops = 2 + nbits;
        } else {
            nops = 2;
        }
    }
    int total;
    const int carry = static_cast<int>(ln.ops & 3);
    int p = carry + cta_exscan(nops, wsum, &total);
    if (tid < ntok) {
        if (tok == kEos) {
            stm[p] = 0; sts[p] = 0;
            stm[p + 1] = 1; sts[p + 1] = 0xFF;
            for (int k = 2; k < 10; k++) { stm[p + k] = 254; sts[p + k] = 0; }
        } else if (tok >> 16) {
            const uint32_t dist = tok & 0xFFFF;
            stm[p] = 0; sts[p] = 0;
            stm[p + 1] = 1; sts[p + 1] = static_cast<uint8_t>(tok >> 16);
            stm[p + 2] = 3; sts[p + 2] = static_cast<uint8_t>(nbits);
            for (int k = 0; k + 1 < nbits; k++) {
                stm[p + 3 + k] = static_cast<uint8_t>(4 + k);
                sts[p + 3 + k] = (dist >> k) & 1;
            }
        } else {
            stm[p] = 0; sts[p] = 1;
            stm[p + 1] = 2; sts[p + 1] = static_cast<uint8_t>(tok);
        }
    }
    const int nb = carry + total;
    if (final && tid < 3) { stm[nb + tid] = 0xFF; sts[nb + tid] = 0; }
    __syncthreads();
    const int nw = final ? (nb + 3) >> 2 : nb >> 2;
    const long long base = ln.ops >> 2;
    const uint32_t* m4 = reinterpret_cast<const uint32_t*>(stm);
    const uint32_t* s4 = reinterpret_cast<const uint32_t*>(sts);
    for (int w = tid; w < nw; w += kParseThreads) {
        if (base + w < ln.rows) {
            ln.m_out[base + w] = __byte_perm(m4[w], 0, 0x0123);
            ln.s_out[base + w] = __byte_perm(s4[w], 0, 0x0123);
        }
    }
    ln.ops += total;
    if (final) {
        for (long long w = base + nw + tid; w < ln.rows; w += kParseThreads) {
            ln.m_out[w] = 0xFFFFFFFFu;
            ln.s_out[w] = 0;
        }
        return;
    }
    __syncthreads();   // the words are read before the carry moves
    if (tid < (nb & 3)) {
        stm[tid] = stm[4 * nw + tid];
        sts[tid] = sts[4 * nw + tid];
    }
}

__global__ void __launch_bounds__(kParseThreads)
sqz4_exact_parse_kernel(const uint8_t* __restrict__ data,
                        const long long* __restrict__ lanes, int n,
                        long long hist_off, int hist_len, int window, int lz,
                        long long rows, uint32_t* __restrict__ m_words,
                        uint32_t* __restrict__ s_words,
                        long long* __restrict__ counts) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int bufb = buffer_bytes(window);
    uint32_t* buf = reinterpret_cast<uint32_t*>(smem);
    uint8_t* bufc = smem;
    uint8_t* stm = smem + bufb;
    uint8_t* sts = stm + kStage;
    uint32_t* tokq = reinterpret_cast<uint32_t*>(sts + kStage);
    int* wsum = reinterpret_cast<int*>(tokq + kParseThreads);   // [64]
    uint32_t* red = tokq + kParseThreads + 64;   // [2][32]
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint16_t* list = reinterpret_cast<uint16_t*>(red + 64) + warp * kListCap;

    const int b = blockIdx.x, tid = threadIdx.x;
    const long long off = lanes[b];
    const int len = static_cast<int>(lanes[n + b]);
    const int hlen = b > 0 && lz ? hist_len : 0;
    const int total = hlen + len;
    Lane ln{m_words + static_cast<long long>(b) * rows,
            s_words + static_cast<long long>(b) * rows, rows, 0};
    int ntok = 0;

    if (!lz) {
        for (int i = 0; i < total; i += kParseThreads) {
            const int k = min(kParseThreads, total - i);
            if (tid < k) tokq[tid] = data[off + i + tid];
            flush(tokq, k, false, stm, sts, wsum, ln);
        }
    } else {
        int s = 0, e = 0;       // the buffer holds stream bytes [s, e)
        int par = 0;
        for (int i = hlen; i < total;) {
            if (i + kReach > s + bufb || e == 0) {
                // slide: keep [s2, e), load [e, s2 + bufb)
                const int s2 = e == 0 ? 0 : (max(0, i - window + 1) & ~15);
                __syncthreads();
                const int kept = e - s2;
                const uint4* src = reinterpret_cast<const uint4*>(bufc + (s2 - s));
                uint4* dst = reinterpret_cast<uint4*>(bufc);
                for (int r0 = 0; r0 < kept; r0 += kParseThreads * 16 * kMoveWords) {
                    uint4 v[kMoveWords];
#pragma unroll
                    for (int k = 0; k < kMoveWords; k++) {
                        const int u = r0 / 16 + k * kParseThreads + tid;
                        if (u * 16 < kept) v[k] = src[u];
                    }
                    __syncthreads();
#pragma unroll
                    for (int k = 0; k < kMoveWords; k++) {
                        const int u = r0 / 16 + k * kParseThreads + tid;
                        if (u * 16 < kept) dst[u] = v[k];
                    }
                    __syncthreads();
                }
                const int e2 = min(total, s2 + bufb);
                for (int p = max(e, s2) + tid; p < e2; p += kParseThreads)
                    bufc[p - s2] = stream_byte(data, hist_off, hlen, off, p);
                s = s2;
                e = e2;
                __syncthreads();
            }
            const int cap = min(kMaxMatch, total - i);
            const int lo = max(0, i - window + 1);
            const int ib = i - s;
            const uint32_t cw = word_at(buf, ib);
            uint32_t key = 0;
            if (cap >= kMinMatch && i > lo) {
                const int la = lo - s, ga = la >> 4, gb = (ib - 1) >> 4;
                const uint32_t c0 = __byte_perm(cw, 0, 0x0000);
                const uint32_t c1 = __byte_perm(cw, 0, 0x1111);
                const uint32_t c2 = __byte_perm(cw, 0, 0x2222);
                const uint32_t c3 = __byte_perm(cw, 0, 0x3333);
                const uint4* buf4 = reinterpret_cast<const uint4*>(buf);
                // the warp's lanes take the same number of rounds (its
                // first lane's), so that they share their best after each
                const int gw = gb - (tid & ~31);
                const int rounds = gw >= ga ? (gw - ga) / kParseThreads + 1
                                            : 0;
                int nlist = 0;   // the warp's queued long candidates
                for (int r = 0; r < rounds; r++) {
                    const int g = gb - tid - r * kParseThreads;
                    uint32_t m4w[4] = {0, 0, 0, 0};
                    int cnt = 0;
                    if (g >= ga) {
                        const uint4 v = buf4[g];
                        const uint32_t a[5] = {v.x, v.y, v.z, v.w,
                                               buf[4 * g + 4]};
                        uint32_t z[4], any = 0;
#pragma unroll
                        for (int w = 0; w < 4; w++) {
                            z[w] = (a[w] ^ c0)
                                   | (__funnelshift_r(a[w], a[w + 1], 8) ^ c1);
                            any |= any_zero_byte(z[w]);
                        }
                        if (any || g == ga || g == gb) {
#pragma unroll
                            for (int w = 0; w < 4; w++) {
                                const int base = 16 * g + 4 * w;
                                uint32_t m2 = zero_bytes(z[w])
                                              & range_mask(base, la, ib);
                                if (!m2) continue;
                                const uint32_t z2 = z[w]
                                    | (__funnelshift_r(a[w], a[w + 1], 16) ^ c2);
                                const uint32_t m3 = zero_bytes(z2);
                                const uint32_t m4 = m2 & zero_bytes(
                                    z2 | (__funnelshift_r(a[w], a[w + 1], 24)
                                          ^ c3));
                                // 4 bytes or more, under a cap above 4:
                                // queued for the warp to extend together
                                if (cap > 4) {
                                    m4w[w] = m4;
                                    cnt += __popc(m4);
                                    m2 &= ~m4;
                                }
                                // the others' lengths are known
                                while (m2) {
                                    const int bit = 31 - __clz(m2);
                                    m2 ^= 1u << bit;
                                    const uint32_t l = min(
                                        cap, 2 + static_cast<int>(
                                                 ((m3 >> bit) & 1)
                                                 + ((m4 >> bit) & 1)));
                                    key = max(key, (l << 16) | static_cast<
                                        uint32_t>(base + (bit >> 3) - la));
                                }
                            }
                        }
                    }
                    if (__any_sync(0xffffffffu, cnt)) {
                        int at = cnt;   // the lane's place in the list
#pragma unroll
                        for (int k = 1; k < 32; k <<= 1) {
                            const int y = __shfl_up_sync(0xffffffffu, at, k);
                            if (lane >= k) at += y;
                        }
                        const int total = __shfl_sync(0xffffffffu, at, 31);
                        at += nlist - cnt;
                        const bool fits = nlist + total <= kListCap;
                        // nearest first: the lane's words downwards
#pragma unroll
                        for (int w = 3; w >= 0; w--) {
                            for (uint32_t m = m4w[w]; m;) {
                                const int bit = 31 - __clz(m);
                                m ^= 1u << bit;
                                const int jb = 16 * g + 4 * w + (bit >> 3);
                                const uint32_t d = jb - la;
                                if (fits) list[at++] = static_cast<uint16_t>(d);
                                else take_long(jb, d, ib, cap, buf, key);
                            }
                        }
                        if (fits) nlist += total;
                    }
                    key = __reduce_max_sync(0xffffffffu, key);
                }
                // the queued candidates, a lane each, nearest first
                __syncwarp();
                for (int e = lane; e - lane < nlist; e += 32) {
                    if (e < nlist)
                        take_long(la + list[e], list[e], ib, cap, buf, key);
                    key = __reduce_max_sync(0xffffffffu, key);
                }
                __syncwarp();
                if (lane == 0) red[par * 32 + warp] = key;
                __syncthreads();
                key = __reduce_max_sync(0xffffffffu, lane < kParseWarps
                                        ? red[par * 32 + lane] : 0);
                par ^= 1;
            }
            int l = static_cast<int>(key >> 16);
            uint32_t tok = cw & 0xFF;
            if (l >= kMinMatch) {
                const uint32_t dist = static_cast<uint32_t>(
                    i - (lo + static_cast<int>(key & 0xFFFF)));
                const int nbits = 32 - __clz(dist);
                if (l <= 3 && nbits > 3) l = 0;
                else tok = (static_cast<uint32_t>(l) << 16) | dist;
            }
            if (tid == 0) tokq[ntok] = tok;
            i += l >= kMinMatch ? l : 1;
            if (++ntok == kParseThreads) {
                flush(tokq, ntok, false, stm, sts, wsum, ln);
                ntok = 0;
            }
        }
    }
    if (tid == 0) tokq[ntok] = kEos;
    flush(tokq, ntok + 1, true, stm, sts, wsum, ln);
    if (tid == 0) counts[b] = ln.ops;
}

}  // namespace sqz4

// data: the bytes (any alignment); lanes: int64 [2, n], lane b's offset
// and length in data; hist_off, hist_len: the history bytes every lane
// but lane 0 parses after (0: none; lz only); window 2..2^16; rows: the
// words a lane's row holds. m_words, s_words: uint32 [n, rows]; counts:
// int64 [n]. Launches n CTAs on `stream`; returns the cudaError_t of the
// launch (cudaErrorInvalidValue for arguments out of range).
extern "C" int sqz4_exact_parse_launch(const void* data, const void* lanes,
                                       int n, long long hist_off,
                                       int hist_len, int window, int lz,
                                       long long rows, void* m_words,
                                       void* s_words, void* counts,
                                       void* stream) {
    if (n <= 0) return 0;
    if (window < sqz4::kMinMatch || window > sqz4::kMaxWindow || rows < 1
        || hist_len < 0 || hist_len > window)
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = sqz4::smem_bytes(window);
    cudaError_t rc = cudaFuncSetAttribute(
        sqz4::sqz4_exact_parse_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    sqz4::sqz4_exact_parse_kernel<<<n, sqz4::kParseThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(data),
        static_cast<const long long*>(lanes), n, hist_off, hist_len, window,
        lz, rows, static_cast<uint32_t*>(m_words),
        static_cast<uint32_t*>(s_words), static_cast<long long*>(counts));
    return static_cast<int>(cudaGetLastError());
}
