"""The CUDA kernels' lane bodies, compiled for the host, against the plain
PyTorch versions.

The sources under ``csrc/`` keep each block's coder (and each column's
copy, for the compaction) in a device function of plain C++ (the kernels
and launchers sit under ``__CUDACC__``), and a thread shares nothing with
its neighbours.
So a host C++ compiler can build the lane bodies as they are, and running
them one lane after another computes what the kernel computes. This
checks the kernel source's arithmetic on a machine with no card; the
card itself is checked by chip_smoke.py and tests/test_torch_cuda.py.

The coders' warp primitives (csrc/sqz4_warp.cuh) give a host compiler a
warp of one lane. A second harness supplies a warp of 32 host threads
instead (shuffles, ballots and syncs through a barrier), so the encoders'
32-lane window arithmetic and the decoder's lane splits run here too, one
block a warp (the two-warp hand-over through named barriers runs only on
the card).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sqz_tpu import native
from sqz_tpu.ops import sqz4_pallas as sp
from sqz_tpu.utils import corpus
from sqz_tpu_torch import convert, native as port_native
from sqz_tpu_torch.ops import probe, resident, sqz4_cuda, sqz4_host as host
from sqz_tpu_torch.ops import sqz4_ref
from sqz_tpu_torch.ops import squeeze_cuda, squeeze_ref
from sqz_tpu_torch.utils import synthetic

# the plain versions step over small tensors: one intra-op thread each,
# so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "sqz_tpu_torch" / "csrc"

# The bit-packer and the compaction as their kernels' CTAs run them, tile
# after tile in order: 32 lanes x tile_rows rows staged with the device's
# pitch (rows and lanes outside the limits zero), then each lane's column
# of the tile through the kernels' device functions on one warp
# (``on_warp``: one host thread, or 32).
TILE_HOSTS = r"""
#include <algorithm>
#include <vector>

// ops [G, T, B] -> words [G, cw, B], lens [G, 8, B], both zero-filled;
// tiles of eight segments of N rows (the kernel's eight warps), a thread
// of the warp packing each of its lanes' segments in order
template <int N>
static void bitpack_tiles(const uint32_t* ops, int G, int T, int B,
                          uint32_t* words, int cw, int32_t* lens) {
    constexpr int kRows = 8 * N;
    constexpr int kWords = (kRows * 25 + 31) / 32 + 1;
    std::vector<uint32_t> tw(sqz_tile::kLanes * kWords);
    std::vector<uint32_t> total(sqz_tile::kLanes);
    for (long long g = 0; g < G; ++g)
        for (int lane0 = 0; lane0 < B; lane0 += sqz_tile::kLanes) {
            const int nl = std::min(sqz_tile::kLanes, B - lane0);
            on_warp([&] {
                std::vector<uint32_t> base(nl, 0u);
                for (int r0 = 0; r0 < T; r0 += kRows) {
                    for (int i = sqz4::lane_id(); i < nl * kWords;
                         i += sqz4::kLanes)
                        tw[i] = 0u;
                    sqz4::warp_sync();
                    for (int c = sqz4::lane_id(); c < nl; c += sqz4::kLanes) {
                        uint32_t off = 0;
                        for (int s = 0; s < 8; ++s) {
                            uint32_t rec[N];
                            uint32_t bits = 0;
                            for (int k = 0; k < N; ++k) {
                                const int r = r0 + s * N + k;
                                rec[k] = r < T
                                    ? ops[(g * T + r) * B + lane0 + c] : 0u;
                                bits += squeeze::record_bits(rec[k]);
                            }
                            if (bits)
                                squeeze::pack_segment(rec, off,
                                                      tw.data() + c * kWords);
                            off += bits;
                        }
                        total[c] = off;
                    }
                    sqz4::warp_sync();
                    // row by row over the rows the lanes' words span
                    uint32_t rmin = ~0u, rmax = 0;
                    for (int c = 0; c < nl; ++c)
                        if (total[c]) {
                            rmin = std::min(rmin, base[c] >> 5);
                            rmax = std::max(rmax,
                                            (base[c] + total[c] - 1) >> 5);
                        }
                    uint32_t* out = words + g * cw * B + lane0;
                    for (uint32_t r = rmin; r <= rmax && rmin <= rmax; ++r)
                        for (int c = sqz4::lane_id(); c < nl;
                             c += sqz4::kLanes)
                            squeeze::store_tile_word(
                                tw.data() + c * kWords, base[c], total[c],
                                r - (base[c] >> 5), out + c, B, cw);
                    sqz4::warp_sync();
                    for (int c = 0; c < nl; ++c) base[c] += total[c];
                }
                if (sqz4::lane_id() == 0)
                    for (int c = 0; c < nl; ++c)
                        lens[g * 8 * B + lane0 + c] =
                            squeeze::payload_bytes(base[c]);
            });
        }
}

extern "C" int host_bitpack(const uint32_t* ops, int G, int T, int B,
                            uint32_t* words, int cw, int32_t* lens,
                            int tile_rows) {
    switch (tile_rows) {
        case 32: bitpack_tiles<4>(ops, G, T, B, words, cw, lens); return 0;
        case 64: bitpack_tiles<8>(ops, G, T, B, words, cw, lens); return 0;
        case 128: bitpack_tiles<16>(ops, G, T, B, words, cw, lens); return 0;
        case 256: bitpack_tiles<32>(ops, G, T, B, words, cw, lens); return 0;
    }
    return -1;
}

// data4: the payload bytes as words, the first at byte `base`;
// offsets, lengths [G * lanes] -> out [G, pw, lanes], every word through
// the pack kernel's device functions
extern "C" void host_pack(const uint32_t* data4, long long base,
                          long long nbytes, const long long* offsets,
                          const long long* lengths, int G, int lanes,
                          int pw, uint32_t* out) {
    for (long long i = 0; i < static_cast<long long>(G) * lanes; ++i) {
        const long long len = sqz4::pack_len(offsets[i], lengths[i],
                                             nbytes, pw);
        const long long g = i / lanes, b = i % lanes;
        for (long long r = 0; r < pw; ++r)
            out[(g * pw + r) * lanes + b] =
                sqz4::pack_word(data4, base + offsets[i], len, r);
    }
}

// words [1, R, B], offsets [nb + 1] -> out [offsets[nb]]
extern "C" void host_compact(const uint32_t* words, int B,
                             const long long* offsets, int nb,
                             uint32_t* out, int tile_rows) {
    using sqz_tile::kPitch;
    std::vector<uint32_t> tile(tile_rows * kPitch);
    for (int lane0 = 0; lane0 < nb; lane0 += sqz_tile::kLanes) {
        const int nl = std::min(sqz_tile::kLanes, nb - lane0);
        const long long* off = offsets + lane0;
        long long longest = 0;
        for (int c = 0; c < nl; ++c)
            longest = std::max(longest, off[c + 1] - off[c]);
        on_warp([&] {
            for (int r0 = 0; r0 < longest; r0 += tile_rows) {
                sqz4::warp_sync();
                for (int i = sqz4::lane_id(); i < tile_rows * 32;
                     i += sqz4::kLanes) {
                    const int r = i / 32, l = i % 32;
                    const long long wc = l < nl ? off[l + 1] - off[l] : 0;
                    tile[r * kPitch + l] =
                        r0 + r < wc ? words[(r0 + r) * (long long)B
                                            + lane0 + l]
                                    : 0u;
                }
                sqz4::warp_sync();
                for (int c = 0; c < nl; ++c) {
                    const long long n = off[c + 1] - off[c] - r0;
                    sqz4::compact_tile_lane(
                        tile.data() + c, kPitch,
                        static_cast<int>(std::min<long long>(n, tile_rows)),
                        out + off[c] + r0);
                }
            }
        });
    }
}
"""


# The cell assembly as its kernel's CTAs run it: tile after tile, each on a
# CTA of `tile` warps (one host thread a warp, or 32) through the kernel's
# tile body, with chunks of `chunk` literal cells; the tile's shared
# memory poisoned before each tile.
CELL_HOSTS = r"""
template <int kTile, int kChunk, int kBufs>
static void cell_tiles(const uint32_t* lit, int lw, const uint32_t* tok,
                       int tw, const uint32_t* mrec, int mw,
                       const int32_t* counts, const int32_t* sizes, int B,
                       int C, uint8_t* blocks, uint8_t* bad) {
    std::vector<uint32_t> smem(
        sqz4_cell::Layout<kTile, kChunk, kBufs>(tw, mw, C).words());
    for (int b0 = 0; b0 < B; b0 += kTile) {
        std::fill(smem.begin(), smem.end(), 0xA5A5A5A5u);
        on_tile(kTile, [&](int tid) {
            sqz4_cell::assemble_tile<kTile, kChunk, kBufs>(
                tid, b0, lit, lw, tok, tw, mrec, mw, counts, sizes, B, C,
                blocks, bad, smem.data());
        });
    }
}

extern "C" int host_cell(const uint32_t* lit, int lw, const uint32_t* tok,
                         int tw, const uint32_t* mrec, int mw,
                         const int32_t* counts, const int32_t* sizes, int B,
                         int C, uint8_t* blocks, uint8_t* bad, int tile,
                         int chunk) {
    using namespace sqz4_cell;
    if (tile == 1 && chunk == 1)
        cell_tiles<1, 1, 2>(lit, lw, tok, tw, mrec, mw, counts, sizes, B, C,
                            blocks, bad);
    else if (tile == 4 && chunk == 2)
        cell_tiles<4, 2, 3>(lit, lw, tok, tw, mrec, mw, counts, sizes, B, C,
                            blocks, bad);
    else if (tile == kTileLanes && chunk == kTileChunk)
        cell_tiles<kTileLanes, kTileChunk, kTileBufs>(
            lit, lw, tok, tw, mrec, mw, counts, sizes, B, C, blocks, bad);
    else
        return -1;
    return 0;
}
"""

# a CTA's barrier for host threads (C++17: a generation count under a
# mutex), ahead of the cell assembly's source
CTA_SHIM = r"""
#define SQZ_HOST_CTA
#include <condition_variable>
#include <mutex>
#include <thread>
namespace sqz4_cell {
struct HostCta {
    std::mutex mu;
    std::condition_variable cv;
    int n, waiting = 0;
    long long gen = 0;
    explicit HostCta(int n_) : n(n_) {}
    void sync() {
        std::unique_lock<std::mutex> lk(mu);
        const long long g = gen;
        if (++waiting == n) {
            waiting = 0;
            ++gen;
            cv.notify_all();
        } else {
            cv.wait(lk, [&] { return gen != g; });
        }
    }
};
inline thread_local HostCta* t_cta = nullptr;
inline void cta_sync() { t_cta->sync(); }
}  // namespace sqz4_cell
"""


# The model statistics kernel's two passes as its warps run them, chunk
# after chunk: pass 1 counts every chunk of every block into hist [n,
# chunks, kSeedWords]; pass 2, from each chunk's base state
# (sqz4_ref.chunk_bases of hist), writes the statistics of the chunks
# listed in sel (nsel < 0: all).
MODEL_HOSTS = r"""
extern "C" int host_model_chunk_ops() { return sqz4::kChunkOps; }

extern "C" void host_model_hist(const uint32_t* m, const uint32_t* s, int n,
                                int rows, int32_t* hist) {
    constexpr int chunk = sqz4::kChunkOps;
    const long long ops = 4LL * rows;
    const long long chunks = (ops + chunk - 1) / chunk;
    std::vector<int> h(sqz4::kSeedWords);
    for (long long b = 0; b < n; ++b)
        for (long long c = 0; c < chunks; ++c)
            on_warp([&] {
                sqz4::count_chunk(m + b * rows, s + b * rows, c * chunk,
                                  static_cast<int>(std::min<long long>(
                                      chunk, ops - c * chunk)),
                                  h.data(),
                                  hist + (b * chunks + c) * sqz4::kSeedWords);
            });
}

extern "C" void host_model_stats(const uint32_t* m, const uint32_t* s,
                                 int n, int rows, int lanes,
                                 const int32_t* base, const int* sel,
                                 int nsel, uint32_t* start, uint32_t* size,
                                 uint32_t* total) {
    constexpr int chunk = sqz4::kChunkOps;
    const long long ops = 4LL * rows;
    const long long chunks = (ops + chunk - 1) / chunk;
    std::vector<int> h(sqz4::kHist);
    for (long long b = 0; b < n; ++b)
        for (long long k = 0; k < (nsel < 0 ? chunks : nsel); ++k) {
            const long long c = nsel < 0 ? k : sel[k];
            const long long out = b / lanes * ops * lanes + b % lanes;
            on_warp([&] {
                sqz4::stats_chunk(m + b * rows, s + b * rows, c * chunk,
                                  static_cast<int>(std::min<long long>(
                                      chunk, ops - c * chunk)),
                                  base + (b * chunks + c) * sqz4::kSeedWords,
                                  h.data(), start + out, size + out,
                                  total + out, lanes);
            });
        }
}
"""

HARNESS = r"""
#define SQZ_DEVICE inline
#define __clzll(x) __builtin_clzll(x)
#include <memory>
#include "sqz4_encode.cu"
#include "sqz4_decode.cu"
#include "sqz4_encode_tok.cu"
#include "sqz4_compact.cu"
#include "sqz4_pack.cu"
#include "squeeze_bitpack.cu"
#include "sqz4_encode_stats.cu"
#include "probe.cu"
#include "sqz4_model_stats.cu"
""" + CTA_SHIM + r"""
#include "sqz4_cell.cu"
#include <algorithm>
#include <vector>

extern "C" void host_encode(const uint32_t* m, const uint32_t* s, int G,
                            int TW, int B, const int32_t* seed, int fresh,
                            uint32_t* words, int cw, int32_t* lens) {
    std::unique_ptr<sqz4::OpSmem> sm(new sqz4::OpSmem);
    for (long long g = 0; g < G; ++g)
        for (long long b = 0; b < B; ++b)
            sqz4::encode_lane(m + g * TW * B + b, s + g * TW * B + b, TW, B,
                              g * B + b == fresh ? nullptr : seed,
                              words + g * cw * B + b, cw,
                              lens + g * 8 * B + b, sm.get(),
                              sqz4::kRoleBoth, 0);
}

extern "C" void host_decode(const uint32_t* p, const int32_t* meta, int G,
                            int pw, int B, unsigned t_max,
                            const int32_t* seed,
                            uint32_t* lit, int lw, uint32_t* tok, int tw,
                            uint32_t* mrec, int mw, int32_t* counts) {
    std::unique_ptr<sqz4::DecSmem> sm(new sqz4::DecSmem);
    for (long long g = 0; g < G; ++g)
        for (long long b = 0; b < B; ++b)
            sqz4::decode_lane(p + g * pw * B + b, pw, meta + g * 8 * B + b,
                              B, t_max, seed, lit + g * lw * B + b, lw,
                              tok + g * tw * B + b, tw,
                              mrec + g * mw * B + b, mw,
                              counts + g * 8 * B + b, sm.get());
}

// the token encoder's gangs (kGang blocks each) in turn, one warp each
extern "C" void host_encode_tok(const uint32_t* toks, int TT,
                                const uint8_t* lits, int L, int G, int B,
                                int t_max, uint32_t* words, int cw,
                                int32_t* lens, int lit_skip) {
    std::unique_ptr<sqz4::TokSmem[]> sm(new sqz4::TokSmem[sqz4::kGang]);
    const sqz4::TokGang gg{toks, TT, lits, L, G * B, B, t_max, words, cw,
                           lens};
    auto run = lit_skip ? sqz4::encode_tok_run<true>
                        : sqz4::encode_tok_run<false>;
    for (long long n0 = 0; n0 < static_cast<long long>(G) * B;
         n0 += sqz4::kGang)
        run(gg, n0, sm.get());
}

extern "C" void host_recip(const uint32_t* d, long long n,
                           unsigned long long* m) {
    for (long long i = 0; i < n; ++i) m[i] = sqz4::recip64(d[i]);
}

extern "C" void host_div(const unsigned long long* num, const uint32_t* d,
                         long long n, unsigned long long* q) {
    for (long long i = 0; i < n; ++i)
        q[i] = sqz4::div_by(num[i], d[i], sqz4::recip64(d[i]));
}

// One op of the decoder's chain from a crafted coder state (state: low,
// rng and code, in and out): kind 0 a binary op with counts a and b, kind
// 1 a 256-symbol op whose counts' inclusive running sums are csum. p: the
// payload column (pw words) read from its first byte. out: the symbol,
// the bad flag and the next 8 payload bytes after the op.
extern "C" void host_dec_op(int kind, int a, int b, const int32_t* csum,
                            const uint32_t* p, int pw,
                            unsigned long long* state,
                            unsigned long long* out) {
    std::unique_ptr<sqz4::DecSmem> sm(new sqz4::DecSmem);
    sqz4::ChainDecoder dec{state[0], state[1], state[2], sqz4::ByteReader{}};
    dec.src.init(p, 1, pw, sm->stage);
    bool bad = false;
    int sym;
    if (kind == 0) {
        sym = dec.binary(a, b, sqz4::recip64(a + b), &bad);
    } else {
        sqz4::LaneModel<256> md;
        md.init(csum);
        sqz4::u64 m = sqz4::recip64(md.total);
        sym = dec.search(sm.get(), md, sqz4::kRcpByte, &m, &bad);
    }
    state[0] = dec.low;
    state[1] = dec.rng;
    state[2] = dec.code;
    out[0] = sym;
    out[1] = bad;
    out[2] = dec.src.take(8);
}

extern "C" void host_encode_stats(const uint32_t* st, const uint32_t* sz,
                                  const uint32_t* tt, int G, int T, int B,
                                  uint32_t* words, int cw, int32_t* lens) {
    std::unique_ptr<sqz4::StatsSmem> sm(new sqz4::StatsSmem);
    for (long long g = 0; g < G; ++g)
        for (long long b = 0; b < B; ++b) {
            const long long in = g * T * B + b;
            sqz4::encode_stats_lane(st + in, sz + in, tt + in, T, B,
                                    words + g * cw * B + b, cw,
                                    lens + g * 8 * B + b, sm.get(),
                                    sqz4::kRoleBoth, 0);
        }
}

extern "C" int host_probe(int which, const void* a, const void* b,
                          uint32_t* out, int lanes, int rows) {
    for (int lane = 0; lane < lanes; ++lane)
        if (probe::probe_lane(which, a, b, out, lanes, rows, lane))
            return -1;
    return 0;
}

// every probe of a batch, CTA after CTA, lane after lane
extern "C" int host_probe_batch(int n, const int* which, const int* rows,
                                const void* const* a, const void* const* b,
                                void* const* out, int lanes) {
    probe::Batch batch;
    if (!probe::make_batch(n, which, rows, a, b, out, lanes, &batch))
        return -1;
    for (int cta = 0; cta < n; ++cta)
        for (int lane = 0; lane < lanes; ++lane)
            if (probe::probe_cta(batch, cta, lane)) return -1;
    return 0;
}

// the one-lane build: a warp's body runs once, in this thread
template <class F>
static void on_warp(F body) { body(); }

// body(tid) on a CTA of `warps` warps of one lane: a host thread each
template <class F>
static void on_tile(int warps, F body) {
    sqz4_cell::HostCta cta(warps);
    std::vector<std::thread> th;
    for (int t = 0; t < warps; ++t)
        th.emplace_back([&, t] {
            sqz4_cell::t_cta = &cta;
            body(t);
        });
    for (auto& t : th) t.join();
}
""" + TILE_HOSTS + CELL_HOSTS + MODEL_HOSTS


WARP_HARNESS = r"""
#define SQZ_DEVICE inline
#define SQZ_HOST_WARP
#define __clzll(x) __builtin_clzll(x)
#include <stdint.h>
#include <barrier>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace sqz4 {
constexpr int kLanes = 32;
struct HostWarp {
    std::barrier<> bar{kLanes};
    long long v[kLanes];
    std::mutex mu;
};
inline thread_local int t_lane = 0;
inline thread_local HostWarp* t_warp = nullptr;
inline int lane_id() { return t_lane; }
inline void warp_sync() { t_warp->bar.arrive_and_wait(); }
inline void bar_wait(int, int) {}
inline void bar_arrive(int, int) {}
// every lane posts x; returns the posts of lanes [0, n) combined by f
template <class F>
inline long long gather(long long x, int n, F f) {
    t_warp->v[t_lane] = x;
    warp_sync();
    long long r = 0;
    for (int l = 0; l < n; ++l) r = f(r, l, t_warp->v[l]);
    warp_sync();
    return r;
}
inline int shfl(int v, int src) {
    return static_cast<int>(gather(v, kLanes, [src](long long r, int l,
                                                    long long x) {
        return l == src ? x : r;
    }));
}
inline long long add(long long r, int, long long x) { return r + x; }
inline int warp_sum(int v) { return static_cast<int>(gather(v, kLanes, add)); }
inline int warp_exscan(int v) {
    return static_cast<int>(gather(v, t_lane, add));
}
inline unsigned ballot(bool p) {
    return static_cast<unsigned>(gather(p, kLanes, [](long long r, int l,
                                                      long long x) {
        return r | (x ? 1ll << l : 0ll);
    }));
}
inline void smem_add(int* p, int v) {
    std::lock_guard<std::mutex> lk(t_warp->mu);
    *p += v;
}
inline void smem_or(uint32_t* p, uint32_t v) {
    std::lock_guard<std::mutex> lk(t_warp->mu);
    *p |= v;
}
inline uint32_t bswap32(uint32_t x) { return __builtin_bswap32(x); }
inline int popc(unsigned x) { return __builtin_popcount(x); }
inline int lowest(unsigned x) { return x ? __builtin_ctz(x) : kLanes; }
}  // namespace sqz4

#include "sqz4_encode.cu"
#include "sqz4_encode_stats.cu"
#include "sqz4_encode_tok.cu"
#include "sqz4_decode.cu"
#include "sqz4_compact.cu"
#include "sqz4_pack.cu"
#include "squeeze_bitpack.cu"
#include "sqz4_model_stats.cu"

""" + CTA_SHIM + r"""
#include "sqz4_cell.cu"

// body(tid) on a CTA of `warps` warps of 32 host threads
template <class F>
static void on_tile(int warps, F body) {
    sqz4_cell::HostCta cta(warps * sqz4::kLanes);
    std::unique_ptr<sqz4::HostWarp[]> w(new sqz4::HostWarp[warps]);
    std::vector<std::thread> th;
    for (int t = 0; t < warps * sqz4::kLanes; ++t)
        th.emplace_back([&, t] {
            sqz4::t_lane = t % sqz4::kLanes;
            sqz4::t_warp = &w[t / sqz4::kLanes];
            sqz4_cell::t_cta = &cta;
            body(t);
        });
    for (auto& t : th) t.join();
}

// body() on a warp of 32 host threads, one lane each
template <class F>
static void on_warp(F body) {
    sqz4::HostWarp w;
    std::vector<std::thread> th;
    for (int l = 0; l < sqz4::kLanes; ++l)
        th.emplace_back([&, l] {
            sqz4::t_lane = l;
            sqz4::t_warp = &w;
            body();
        });
    for (auto& t : th) t.join();
}

extern "C" void host_encode(const uint32_t* m, const uint32_t* s, int G,
                            int TW, int B, const int32_t* seed, int fresh,
                            uint32_t* words, int cw, int32_t* lens) {
    std::unique_ptr<sqz4::OpSmem> sm(new sqz4::OpSmem);
    for (long long g = 0; g < G; ++g)
        for (long long b = 0; b < B; ++b)
            on_warp([&] {
                sqz4::encode_lane(m + g * TW * B + b, s + g * TW * B + b, TW,
                                  B, g * B + b == fresh ? nullptr : seed,
                                  words + g * cw * B + b, cw,
                                  lens + g * 8 * B + b, sm.get(),
                                  sqz4::kRoleBoth, 0);
            });
}

extern "C" void host_encode_stats(const uint32_t* st, const uint32_t* sz,
                                  const uint32_t* tt, int G, int T, int B,
                                  uint32_t* words, int cw, int32_t* lens) {
    std::unique_ptr<sqz4::StatsSmem> sm(new sqz4::StatsSmem);
    for (long long g = 0; g < G; ++g)
        for (long long b = 0; b < B; ++b)
            on_warp([&] {
                const long long in = g * T * B + b;
                sqz4::encode_stats_lane(st + in, sz + in, tt + in, T, B,
                                        words + g * cw * B + b, cw,
                                        lens + g * 8 * B + b, sm.get(),
                                        sqz4::kRoleBoth, 0);
            });
}

// the token encoder's gangs (kGang blocks each) in turn, one warp each
extern "C" void host_encode_tok(const uint32_t* toks, int TT,
                                const uint8_t* lits, int L, int G, int B,
                                int t_max, uint32_t* words, int cw,
                                int32_t* lens, int lit_skip) {
    std::unique_ptr<sqz4::TokSmem[]> sm(new sqz4::TokSmem[sqz4::kGang]);
    const sqz4::TokGang gg{toks, TT, lits, L, G * B, B, t_max, words, cw,
                           lens};
    auto run = lit_skip ? sqz4::encode_tok_run<true>
                        : sqz4::encode_tok_run<false>;
    for (long long n0 = 0; n0 < static_cast<long long>(G) * B;
         n0 += sqz4::kGang)
        on_warp([&] { run(gg, n0, sm.get()); });
}

extern "C" void host_decode(const uint32_t* p, const int32_t* meta, int G,
                            int pw, int B, unsigned t_max,
                            const int32_t* seed,
                            uint32_t* lit, int lw, uint32_t* tok, int tw,
                            uint32_t* mrec, int mw, int32_t* counts) {
    std::unique_ptr<sqz4::DecSmem> sm(new sqz4::DecSmem);
    for (long long g = 0; g < G; ++g)
        for (long long b = 0; b < B; ++b)
            on_warp([&] {
                sqz4::decode_lane(p + g * pw * B + b, pw,
                                  meta + g * 8 * B + b, B, t_max, seed,
                                  lit + g * lw * B + b, lw,
                                  tok + g * tw * B + b, tw,
                                  mrec + g * mw * B + b, mw,
                                  counts + g * 8 * B + b, sm.get());
            });
}
""" + TILE_HOSTS + CELL_HOSTS + MODEL_HOSTS


def _build(tmp_path_factory, name, source, std):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp(name)
    (d / "harness.cpp").write_text(source)
    so = d / f"lib{name}.so"
    subprocess.run([cxx, "-O2", f"-std={std}", "-pthread", "-Wall",
                    "-Wextra", "-Werror", "-shared", "-fPIC", f"-I{CSRC}",
                    "-o", str(so), str(d / "harness.cpp")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(so))


def _coder_argtypes(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_encode.argtypes = [p, p, i, i, i, p, i, p, i, p]
    lib.host_decode.argtypes = [p, p, i, i, i, ctypes.c_uint, p, p, i, p, i,
                                p, i, p]
    lib.host_encode_tok.argtypes = [p, i, p, i, i, i, i, p, i, p, i]
    lib.host_encode_stats.argtypes = [p, p, p, i, i, i, p, i, p]
    lib.host_model_hist.argtypes = [p, p, i, i, p]
    lib.host_model_stats.argtypes = [p, p, i, i, i, p, p, i, p, p, p]
    return lib


def _tile_argtypes(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_compact.argtypes = [p, i, p, i, p, i]
    lib.host_pack.argtypes = [p, ctypes.c_longlong, ctypes.c_longlong, p,
                              p, i, i, i, p]
    lib.host_bitpack.argtypes = [p, i, i, i, p, i, p, i]
    lib.host_bitpack.restype = i
    lib.host_cell.argtypes = [p, i, p, i, p, i, p, p, i, i, p, p, i, i]
    lib.host_cell.restype = i
    return lib


@pytest.fixture(scope="module")
def warp_lib(tmp_path_factory):
    """The coders, the bit-packer and the compaction on a warp of 32 host
    threads (WARP_HARNESS)."""
    return _tile_argtypes(_coder_argtypes(_build(
        tmp_path_factory, "sqz4warp", WARP_HARNESS, "c++20")))


@pytest.fixture(scope="module")
def lanes_lib(tmp_path_factory):
    lib = _tile_argtypes(_coder_argtypes(_build(
        tmp_path_factory, "csrc_host", HARNESS, "c++17")))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_probe.argtypes = [i, p, p, p, i, i]
    lib.host_probe_batch.argtypes = [i, p, p, p, p, p, i]
    lib.host_recip.argtypes = [p, ctypes.c_longlong, p]
    lib.host_div.argtypes = [p, p, ctypes.c_longlong, p]
    lib.host_dec_op.argtypes = [i, i, i, p, p, i, p, p]
    return lib


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _host_stats(st, lanes):
    """The stats-fed encoder's [G, T, lanes] inputs as host arrays."""
    return [convert.to_numpy(a)
            for a in sqz4_cuda.pack_group_stats(st, "cpu", lanes)]


def _data(bs: int) -> bytes:
    return (corpus.texty(5 * bs, seed=1) + corpus.rle4(2 * bs)
            + corpus.zeros(bs) + corpus.random_bytes(2 * bs, seed=2)
            + corpus.texty(bs // 3, seed=3))


@pytest.mark.parametrize("paired", [False, True])
def test_encoder_lanes_equal_plain_version(lanes_lib, paired):
    blk, lanes = 10, 4
    bs = 1 << blk
    data = _data(bs)
    nb = -(-len(data) // bs)
    mw, sw, mx = native.sqz4_plan_pack(data, 1 << 10, blk, True, lanes,
                                       host.op_stream_cap(blk), paired=paired)
    rows = -(-int(mx) // 4)
    m, s = (np.ascontiguousarray(a[:, :rows]) for a in (mw, sw))
    cw = host.cap_words_for(bs + 2048)
    G = m.shape[0]
    words = np.zeros((G, cw, lanes), np.uint32)
    lens = np.zeros((G, 8, lanes), np.int32)
    lanes_lib.host_encode(_ptr(m), _ptr(s), G, rows, lanes, None, -1,
                          _ptr(words), cw, _ptr(lens))
    want = sqz4_ref.encode_full_ref(torch.from_numpy(m.view(np.int32)).view(
        torch.uint32), torch.from_numpy(s.view(np.int32)).view(torch.uint32),
        cw)
    np.testing.assert_array_equal(words, convert.to_numpy(want[0]))
    np.testing.assert_array_equal(lens, convert.to_numpy(want[1]))
    assert (host.unpack_group_payloads(words, lens, nb)
            == native.blocks_compress(data, 1, 10, blk))


def _decode_lanes(lib, payloads, sizes, blk, lanes, seed=None, dlen=0,
                  t_max=None):
    """The decoder's lane bodies on payloads: ([lit, tok, mrec, counts] in
    the kernel's layouts, the plan, the packed buffer and meta); ``t_max``
    overrides the plan's step budget."""
    plan = host.plan_decode_dispatch(len(payloads), blk, lanes=lanes)
    buf, meta = host.pack_decode_chunk(payloads, sizes, lanes, plan["G"],
                                       plan["Pw"], dlen)
    G, pw = plan["G"], plan["Pw"]
    lw, tw, mw = plan["lw"], plan["tw"], plan["mw"]
    t_max = plan["t_max"] if t_max is None else t_max
    got = [np.zeros((G, n, lanes), np.uint32) for n in (lw, tw, mw)]
    got.append(np.zeros((G, 8, lanes), np.int32))
    lib.host_decode(_ptr(buf), _ptr(meta), G, pw, lanes, t_max,
                    None if seed is None else _ptr(seed),
                    _ptr(got[0]), lw, _ptr(got[1]), tw, _ptr(got[2]), mw,
                    _ptr(got[3]))
    return got, plan, buf, meta


def _decode_both(lib, payloads, sizes, blk, lanes, seed=None, dlen=0):
    """The decoder's lane bodies and its plain version on the same inputs
    (``seed``: the seed column, int32 [610], for the seeded mode; ``dlen``
    the dictionary length in the meta rows)."""
    got, plan, buf, meta = _decode_lanes(lib, payloads, sizes, blk, lanes,
                                         seed, dlen)
    lw, tw, mw, t_max = plan["lw"], plan["tw"], plan["mw"], plan["t_max"]
    pt, mt = convert.decoder_inputs(buf, meta, "cpu")
    want = [convert.to_numpy(a) for a in sqz4_ref.decode_ref(
        pt, mt, t_max, lw, tw, mw,
        None if seed is None else torch.from_numpy(seed))]
    return got, want


def test_decoder_lanes_equal_plain_version(lanes_lib):
    blk, lanes = 10, 4
    bs = 1 << blk
    data = _data(bs)
    payloads = native.blocks_compress(data, 1, 10, blk)
    sizes = [len(data[o:o + bs]) for o in range(0, len(data), bs)]
    got, want = _decode_both(lanes_lib, payloads, sizes, blk, lanes)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    outs = host.postprocess_decode(*got, payloads, sizes, bs)
    assert b"".join(outs) == data


def test_decoder_lanes_take_a_budget_past_int32(lanes_lib):
    # the step budget of a 2^28-byte block, 9 * 2^28 + 64, passes int32:
    # the kernel's budget and step counter are unsigned, and a small block
    # under it decodes to the same streams and counts as under its own
    blk, lanes = 10, 4
    bs = 1 << blk
    data = _data(bs)
    payloads = native.blocks_compress(data, 1, 10, blk)
    sizes = [len(data[o:o + bs]) for o in range(0, len(data), bs)]
    wide = 9 * (1 << 28) + 64
    assert wide > 1 << 31
    got = _decode_lanes(lanes_lib, payloads, sizes, blk, lanes,
                        t_max=wide)[0]
    own = _decode_lanes(lanes_lib, payloads, sizes, blk, lanes)[0]
    for a, b in zip(got, own):
        np.testing.assert_array_equal(a, b)
    assert got[3][:, 5].max() > 0
    assert b"".join(host.postprocess_decode(*got, payloads, sizes,
                                            bs)) == data


def test_decoder_lanes_flag_corrupt_streams_like_plain_version(lanes_lib):
    blk, lanes = 9, 8
    bs = 1 << blk
    rng = np.random.default_rng(77)
    data = corpus.texty(lanes * bs, seed=8)
    payloads = native.blocks_compress(data, 1, 10, blk)
    for b in range(lanes):
        p = bytearray(payloads[b])
        for _ in range(b % 3 + 1):
            p[int(rng.integers(0, len(p)))] ^= int(rng.integers(1, 256))
        payloads[b] = bytes(p)
    got, want = _decode_both(lanes_lib, payloads, [bs] * lanes, blk, lanes)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[3][0, 4].any()


@pytest.mark.parametrize("lz", [True, False])
def test_token_encoder_lanes_equal_plain_version(lanes_lib, lz):
    blk, lanes = 10, 4
    bs = 1 << blk
    data = _data(bs)
    nb = -(-len(data) // bs)
    tok_cap, lit_cap = host.tok_caps(blk)
    toks, lits, counts, mx = port_native.sqz4_tok_plan(
        data, 1 << 10, blk, lz, tok_cap, lit_cap)
    assert (counts[:, 2] >= 0).all()
    G = -(-nb // lanes)
    tt = np.zeros((G * lanes, int(counts[:, 0].max())), np.uint32)
    lt = np.zeros((G * lanes, int(counts[:, 1].max())), np.uint8)
    tt[:nb] = toks[:, :tt.shape[1]]
    lt[:nb] = lits[:, :lt.shape[1]]
    tt, lt = tt.reshape(G, lanes, -1), lt.reshape(G, lanes, -1)
    cw = host.cap_words_for(bs + 2048)
    words = np.zeros((G, cw, lanes), np.uint32)
    lens = np.zeros((G, 8, lanes), np.int32)
    lanes_lib.host_encode_tok(_ptr(tt), tt.shape[2], _ptr(lt), lt.shape[2],
                              G, lanes, int(mx), _ptr(words), cw, _ptr(lens),
                              0)
    want = sqz4_ref.encode_tok_ref(
        torch.from_numpy(tt.view(np.int32)).view(torch.uint32),
        torch.from_numpy(lt), int(mx), cw)
    np.testing.assert_array_equal(words, convert.to_numpy(want[0]))
    np.testing.assert_array_equal(lens, convert.to_numpy(want[1]))
    assert (host.unpack_group_payloads(words, lens, nb)
            == native.blocks_compress(data, 1, 10, blk, lz=lz,
                                      parse="fast"))


def _tok_inputs(data, blk, lanes, lz=True):
    """The token planner's rows for ``data``, padded to whole groups of
    ``lanes`` blocks: (toks [G, lanes, Tt], lits [G, lanes, L], pair
    budget, block count)."""
    bs = 1 << blk
    nb = -(-len(data) // bs)
    tok_cap, lit_cap = host.tok_caps(blk)
    toks, lits, counts, mx = port_native.sqz4_tok_plan(
        data, 1 << 10, blk, lz, tok_cap, lit_cap)
    G = -(-nb // lanes)
    tt = np.zeros((G * lanes, int(counts[:, 0].max())), np.uint32)
    lt = np.zeros((G * lanes, int(counts[:, 1].max())), np.uint8)
    tt[:nb] = toks[:, :tt.shape[1]]
    lt[:nb] = lits[:, :lt.shape[1]]
    return tt.reshape(G, lanes, -1), lt.reshape(G, lanes, -1), int(mx), nb


def _encode_tok_both(lib, tt, lt, t_max, cw, lit_skip=False):
    """The token encoder's lane bodies (its gangs) and its plain version on
    the same rows."""
    G, lanes = tt.shape[:2]
    words = np.zeros((G, cw, lanes), np.uint32)
    lens = np.zeros((G, 8, lanes), np.int32)
    lib.host_encode_tok(_ptr(tt), tt.shape[2], _ptr(lt), lt.shape[2], G,
                        lanes, t_max, _ptr(words), cw, _ptr(lens),
                        int(lit_skip))
    want = sqz4_ref.encode_tok_ref(
        torch.from_numpy(tt.view(np.int32)).view(torch.uint32),
        torch.from_numpy(lt), t_max, cw, lit_skip)
    return (words, lens), [convert.to_numpy(x) for x in want]


def test_token_encoder_lanes_code_literal_heavy_blocks(lanes_lib):
    # random bytes: every block a run of literal tokens (a flag and a
    # byte an op pair), the literal chunks of the token-level producer
    blk, lanes = 10, 4
    data = corpus.random_bytes(6 << blk, seed=4) + corpus.texty(300, seed=5)
    tt, lt, mx, nb = _tok_inputs(data, blk, lanes)
    cw = host.cap_words_for((1 << blk) + 2048)
    got, want = _encode_tok_both(lanes_lib, tt, lt, mx, cw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (host.unpack_group_payloads(*got, nb)
            == native.blocks_compress(data, 1, 10, blk, parse="fast"))


@pytest.mark.parametrize("cut", [0, 1, 2, 3, 5, 17, 100, 333, -7, -3, -1,
                                 9])
def test_token_encoder_lanes_stop_at_the_pair_budget(lanes_lib, cut):
    # a budget below the blocks' pairs cuts them mid-token, as the plain
    # version's (token, phase) machine does (cut < 0: that many pairs
    # below the longest block's; 9: above it)
    blk, lanes = 10, 4
    data = corpus.texty(3 << blk, seed=1) + corpus.random_bytes(1 << blk,
                                                                seed=2)
    tt, lt, mx, _ = _tok_inputs(data, blk, lanes)
    t_max = mx + cut if cut < 0 or cut == 9 else cut
    got, want = _encode_tok_both(lanes_lib, tt, lt, t_max,
                                 host.cap_words_for((1 << blk) + 2048))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _skip_inputs(nb, blk, lanes, seed):
    """synthetic.skip_tokens' rows and raw blocks, padded to whole groups
    of ``lanes`` blocks: (toks [G, lanes, Tt], raw [G, lanes, bs], the
    longest row's pairs)."""
    toks, raw, pairs = synthetic.skip_tokens(nb, blk, seed)
    G = -(-nb // lanes)
    tt = np.zeros((G * lanes, toks.shape[1]), np.uint32)
    lt = np.zeros((G * lanes, raw.shape[1]), np.uint8)
    tt[:nb], lt[:nb] = toks, raw
    return (tt.reshape(G, lanes, -1), lt.reshape(G, lanes, -1),
            int(pairs.max()))


@pytest.mark.parametrize("cut", [0, 1, 5, 6, 7, 9, 12, 13, 270, 400, -3,
                                 -1, 10 ** 6])
def test_lit_skip_lanes_stop_at_the_pair_budget(lanes_lib, cut):
    # the lit_skip mode's match tokens move the literal cursor (jumps
    # across the literal window's 256-byte chunks, over several chunks at
    # once) and hold the lane until the drain ends; a budget that ends
    # inside such a wait stops the lane where the plain version's machine
    # does (lane 0: pairs 7..12 wait on a len-254 dist-1 match; cut 0:
    # the longest lane's pairs, < 0 below them, 10^6 above)
    tt, lt, mx = _skip_inputs(10, 11, 4, seed=5)
    t_max = mx + cut if cut <= 0 else cut
    cw = host.cap_words_for((1 << 11) + 2048)
    got, want = _encode_tok_both(lanes_lib, tt, lt, t_max, cw,
                                 lit_skip=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if cut == 0:
        # the cold mode codes the same ops from the compacted literals
        lits = sqz4_ref.skip_literal_rows(
            torch.from_numpy(tt.view(np.int32)).view(torch.uint32),
            torch.from_numpy(lt)).numpy()
        cold, _ = _encode_tok_both(lanes_lib, tt, lits, t_max, cw)
        for a, b in zip(got, cold):
            np.testing.assert_array_equal(a, b)


def _mix_rows(parse, nb, blk, seed):
    """The resident mix's raw blocks (five lane kinds, the last block a
    third long) with the cell parse's (rle) or the device LZ parse's (lz)
    token rows, made on the CPU: (toks [1, nb, Tt], raw [1, nb, bs], the
    longest row's pairs, valid lengths [nb])."""
    from sqz_tpu_torch.ops import lzparse
    blocks, lengths, _ = resident._prep_blocks(
        synthetic.resident_mix(nb, blk, seed=seed), blk, nb, "cpu")
    if parse == "rle":
        toks, pairs = resident.rle_plan_device(
            blocks, lengths, resident.rle_group_args(blk)["Tt"])
    else:
        toks, pairs, _ = lzparse.lz_plan_device(
            blocks, lengths, lzparse.lz_group_args(blk)["Tt"])
    return (toks.view(torch.int32).numpy().view(np.uint32),
            blocks[None].numpy(), int(pairs.max()), lengths.numpy())


@pytest.mark.parametrize("parse", ["rle", "lz"])
@pytest.mark.parametrize("harness", ["lanes", "warp"])
def test_lit_skip_lanes_code_every_resident_lane_kind(request, harness,
                                                      parse):
    # lit_skip over the resident mix's raw blocks (sparse weights, periods
    # whose match cells skip whole 256-byte literal chunks, repeated
    # cells, pseudo-text, random bytes; ten lanes: gangs of four, four and
    # two): equal to the plain version, to the cold mode on the compacted
    # literals, and decoded by the native copy to the block; a lane with
    # no match is the native copy's literal-only payload
    lib = request.getfixturevalue(f"{harness}_lib")
    blk, nb = 11, 10
    tt, raw, mx, lengths = _mix_rows(parse, nb, blk, seed=11)
    cw = host.cap_words_for((1 << blk) + 2048)
    got, want = _encode_tok_both(lib, tt, raw, mx, cw, lit_skip=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    lits = sqz4_ref.skip_literal_rows(
        torch.from_numpy(tt.view(np.int32)).view(torch.uint32),
        torch.from_numpy(raw)).numpy()
    cold, _ = _encode_tok_both(request.getfixturevalue("lanes_lib"), tt,
                               lits, mx, cw)
    for a, b in zip(got, cold):
        np.testing.assert_array_equal(a, b)
    payloads = host.unpack_group_payloads(*got, nb)
    t = tt[0].astype(np.int64)
    matched = (((t >> 8) & 1) == 1) & ((t & 0xFF) != 255)
    assert matched.any(1).sum() >= 4
    for b in range(nb):
        block = raw[0, b, :lengths[b]].tobytes()
        assert port_native.sqz4_decompress_payload(
            payloads[b], len(block)) == block
        if not matched[b].any():
            assert payloads[b] == port_native.sqz4_compress_payload(
                block, 1 << 15, lz=False)


def test_decoder_lanes_decode_literal_heavy_blocks(lanes_lib):
    blk, lanes = 10, 4
    bs = 1 << blk
    data = corpus.random_bytes(6 * bs, seed=6) + corpus.texty(bs // 2,
                                                              seed=7)
    payloads = native.blocks_compress(data, 1, 10, blk)
    sizes = [len(data[o:o + bs]) for o in range(0, len(data), bs)]
    got, want = _decode_both(lanes_lib, payloads, sizes, blk, lanes)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert b"".join(host.postprocess_decode(*got, payloads, sizes,
                                            bs)) == data


@pytest.mark.parametrize("kind", ["flip", "truncate", "noise"])
def test_decoder_lanes_count_corrupt_lanes_like_plain_version(lanes_lib,
                                                               kind):
    # the counts rows err (4), steps (5) and state (7) of corrupt lanes,
    # literal-heavy and match-heavy, as the plain version gives them
    blk, lanes = 9, 8
    bs = 1 << blk
    rng = np.random.default_rng(len(kind))
    data = (corpus.texty(4 * bs, seed=9)
            + corpus.random_bytes(4 * bs, seed=10))
    payloads = native.blocks_compress(data, 1, 10, blk)
    for b in range(lanes):
        p = bytearray(payloads[b])
        at = int(rng.integers(0, len(p)))
        if kind == "flip":
            p[at] ^= 1 << int(rng.integers(0, 8))
        elif kind == "truncate":
            del p[at:]
        else:
            p[at:] = rng.integers(0, 256, len(p) - at,
                                  dtype=np.uint8).tobytes()
        payloads[b] = bytes(p)
    got, want = _decode_both(lanes_lib, payloads, [bs] * lanes, blk, lanes)
    np.testing.assert_array_equal(got[3][:, [4, 5, 7]], want[3][:, [4, 5, 7]])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


M64 = (1 << 64) - 1
TOTAL_LIMIT = (1 << 28) + (1 << 14) + 2   # sqz4_div.cuh kTotalLimit


def _check_divider(lib, d, rng, nrand):
    """recip64(d) == (2^64 - 1) // d, and div_by(n, d) == n // d at the
    edge numerators (0, 1, d - 1, d, d + 1, 2^63, 2^64 - 1, k d and k d - 1
    for a random k) and ``nrand`` random ones a divisor, against numpy's
    exact integer //."""
    m = np.zeros(d.size, np.uint64)
    lib.host_recip(_ptr(d), d.size, _ptr(m))
    d64 = d.astype(np.uint64)
    np.testing.assert_array_equal(m, np.uint64(M64) // d64)
    k = rng.integers(1, 1 << 63, d.size, dtype=np.uint64) % m + np.uint64(1)
    nums = [np.zeros_like(d64), np.ones_like(d64), d64 - np.uint64(1), d64,
            d64 + np.uint64(1), np.full_like(d64, 1 << 63),
            np.full_like(d64, M64), k * d64, k * d64 - np.uint64(1)]
    nums += [rng.integers(0, 1 << 64, d.size, dtype=np.uint64)
             for _ in range(nrand)]
    nums = np.concatenate(nums)
    dens = np.tile(d, len(nums) // d.size)
    q = np.zeros(nums.size, np.uint64)
    lib.host_div(_ptr(nums), _ptr(dens), nums.size, _ptr(q))
    np.testing.assert_array_equal(q, nums // dens.astype(np.uint64))


def test_divider_is_exact_for_every_model_total(lanes_lib):
    # sqz4_div.cuh: recip64(d) == (2^64 - 1) // d and div_by(n, d) == n // d
    # for every divisor 1..2^24, at the edge numerators and random ones
    # (two a divisor, eight below 2^17), in chunks of 2^18 divisors
    rng = np.random.default_rng(17)
    for lo in range(1, 1 << 24, 1 << 18):
        d = np.arange(lo, min(lo + (1 << 18), (1 << 24) + 1),
                      dtype=np.uint32)
        _check_divider(lanes_lib, d, rng, 8 if lo < 1 << 17 else 2)


def test_divider_is_exact_near_every_power_of_two(lanes_lib):
    # every divisor within 4096 of 2^k, k = 0..32, below 2^32 (the proof's
    # range; every model total stays below kTotalLimit < 2^29)
    rng = np.random.default_rng(32)
    d = np.unique(np.concatenate([
        np.arange(max(1, (1 << k) - 4096), min((1 << k) + 4097, 1 << 32),
                  dtype=np.uint64) for k in range(33)])).astype(np.uint32)
    _check_divider(lanes_lib, d, rng, 8)


def test_divider_is_exact_for_random_divisors(lanes_lib):
    # a million seeded random divisors below 2^32, half of them below the
    # model-total limit
    rng = np.random.default_rng(64)
    d = np.concatenate([rng.integers(1, 1 << 32, 500_000, dtype=np.uint64),
                        rng.integers(1, TOTAL_LIMIT, 500_000,
                                     dtype=np.uint64)]).astype(np.uint32)
    _check_divider(lanes_lib, d, rng, 2)


def _ref_dec_op(low, rng, code, stream, freqs):
    """One op of the reference decoder (sqz_tpu/ops/sqz4_jax.py
    _decode_scan, FORMAT.md §2.3) in Python integers: the underflow escape
    where the range is below the total, the divide, the saturated
    cumulative count, the interval and the renormalization. Returns (low,
    rng, code, symbol, bad, the next 8 stream bytes, escaped)."""
    pos = 0

    def take(k):
        nonlocal pos
        pos += k
        return int.from_bytes(stream[pos - k:pos].ljust(k, b"\0"), "big")
    total = sum(freqs)
    escaped = rng < total
    if escaped:
        code = ((code << 16) | take(2)) & M64
        low = (low << 16) & M64
        rng = M64 - low
    rd = rng // total
    cum = ((code - low) & M64) // rd
    bad = cum >= total
    cum = min(cum, total - 1)
    csum = np.cumsum(freqs).tolist()
    sym = next(i for i, c in enumerate(csum) if c > cum)
    low = (low + (csum[sym] - freqs[sym]) * rd) & M64
    rng = (freqs[sym] * rd) & M64
    x = low ^ ((low + rng) & M64)
    cnt = 8 if x == 0 else (64 - x.bit_length()) // 8
    if cnt >= 8:
        code, low, rng = take(8), 0, 0
    elif cnt:
        code = ((code << 8 * cnt) | take(cnt)) & M64
        low = (low << 8 * cnt) & M64
        rng = (rng << 8 * cnt) & M64
    return low, rng, code, sym, bad, take(8), escaped


@pytest.mark.parametrize("kind", ["binary", "search"])
def test_decoder_chain_escapes_at_wide_totals(lanes_lib, kind):
    # model totals past 2^17 up to the limit, from crafted coder states:
    # half with the range below the total, so that the underflow escape
    # (ChainDecoder::front) runs, half without; the chain's registers,
    # symbol, bad flag and stream position equal the reference's
    rng = np.random.default_rng(5 if kind == "binary" else 6)
    stream = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    words = np.frombuffer(stream, ">u4").astype(np.uint32)
    escapes = goods = 0
    for i in range(400):
        total = int(rng.integers(1 << 17, TOTAL_LIMIT))
        if kind == "binary":
            a = int(rng.integers(1, total))
            freqs = [a, total - a]
        else:
            cut = np.unique(rng.integers(1, total, 255))
            while cut.size < 255:
                cut = np.unique(np.concatenate([cut, rng.integers(1, total,
                                                                  8)]))[:255]
            freqs = np.diff(np.concatenate([[0], cut, [total]])).tolist()
        low = int(rng.integers(0, 1 << 64, dtype=np.uint64))
        if i % 2:
            r = int(rng.integers(1, total))        # the escape's case
            if M64 - ((low << 16) & M64) < total:
                continue                           # no range left after it
        else:
            r = int(rng.integers(total, 1 << 64, dtype=np.uint64))
        # code inside the range, after the escape where it runs
        span = (M64 - ((low << 16) & M64)) >> 16 if i % 2 else r
        code = (low + int(rng.integers(0, span, dtype=np.uint64))) & M64
        if i % 4 == 3:
            code = int(rng.integers(0, 1 << 64, dtype=np.uint64))
        want = _ref_dec_op(low, r, code, stream, freqs)
        state = np.array([low, r, code], np.uint64)
        out = np.zeros(3, np.uint64)
        csum = np.cumsum(freqs).astype(np.int32)
        lanes_lib.host_dec_op(0 if kind == "binary" else 1, freqs[0],
                              freqs[-1], _ptr(csum), _ptr(words),
                              words.size, _ptr(state), _ptr(out))
        got = (*(int(v) for v in state), int(out[0]), bool(out[1]),
               int(out[2]))
        assert got == want[:6], (i, got, want)
        escapes += want[6]
        goods += not want[4]
    assert escapes >= 150 and goods >= 150


def _ref_encode_stats(ops):
    """The reference's stats-fed coder (sqz_tpu/ops/sqz4_jax.py
    _stats_scan and its emission) in Python integers over (start, size,
    total) ops: (payload bytes, underflow escapes)."""
    low, rng, out, ufs = 0, M64, bytearray(), 0
    for st, sz, tt in ops:
        if tt == 0:
            continue
        if sz == 0:                      # flush: the top byte
            out.append(low >> 56)
            low = (low << 8) & M64
            continue
        q = rng // tt
        low = (low + st * q) & M64
        rng = (q * sz) & M64
        pre = low
        x = low ^ ((low + rng) & M64)
        cnt = 8 if x == 0 else (64 - x.bit_length()) // 8
        low, rng = ((0, 0) if cnt >= 8 else
                    ((low << 8 * cnt) & M64, (rng << 8 * cnt) & M64))
        if rng < tt + 1:
            ufs += 1
            low = 0 if cnt >= 6 else (pre << (8 * cnt + 16)) & M64
            rng = M64 - low
            cnt += 2
        out += bytes((pre >> (56 - 8 * k)) & 0xFF if k < 8 else 0
                     for k in range(cnt))
    return bytes(out), ufs


def _escape_ops(total):
    """Ops of one total that leave the encoder's range below it: each codes
    a symbol of size 1 whose interval straddles 2^63, so nothing
    renormalizes and the range shrinks by the total an op."""
    low, rng, ops = 0, M64, []
    while rng > total:
        q = rng // total
        st = min(((1 << 63) - low) // q, total - 1)
        ops.append((st, 1, total))
        low, rng = low + st * q, q
    return ops


def test_stats_encoder_escapes_at_wide_totals(coder_lib):
    # statistics with totals past 2^17 up to the limit, each lane opening
    # with two ops that force the underflow escape, then random ops
    # (flushes and pads among them): the lane bodies equal the plain
    # version, the reference's stats scan and its arithmetic in Python
    # integers
    from sqz_tpu.ops import sqz4_jax
    rng = np.random.default_rng(9)
    lanes, T = 4, 600
    cols = np.zeros((3, lanes, T), np.uint32)
    ufs = []
    for b in range(lanes):
        tot = rng.integers(1 << 17, TOTAL_LIMIT, T)
        size = rng.integers(1, 1 << 12, T) % tot + 1
        start = rng.integers(0, 1 << 62, T) % (tot - size + 1)
        ops = [(int(a), int(z), int(t)) for a, z, t in zip(start, size, tot)]
        esc = _escape_ops(int(rng.integers(1 << 17, TOTAL_LIMIT)))
        ops[:len(esc)] = esc
        for k in rng.choice(np.arange(8, T - 8), 40, replace=False):
            ops[k] = (0, 0, 1) if k % 2 else (0, 0, 0)
        ops[T - 8:] = [(0, 0, 1)] * 8
        cols[:, b] = np.array(ops, np.uint32).T
        ufs.append(_ref_encode_stats(ops))
    assert all(u >= 1 for _, u in ufs)
    packed = [np.ascontiguousarray(c.T[None]) for c in cols]
    cw = host.cap_words_for(8 * T)
    got, want = _encode_stats_both(coder_lib, packed, cw)
    _assert_equal(got, want)
    pay = host.unpack_group_payloads(*got, lanes)
    assert pay == [p for p, _ in ufs]
    jp, jl = sqz4_jax._encode_scan_stats(*(jnp.asarray(c) for c in cols),
                                         cap=4 * cw)
    assert [np.asarray(jp)[b, :int(jl[b])].tobytes()
            for b in range(lanes)] == pay


def test_coder_lanes_at_blk_bits_18(lanes_lib):
    # random bytes in one block of 140,000 (literal flag total past 2^17):
    # the stats-fed encoder's lane body gives the native payload, and the
    # decoder's restores it
    data = corpus.random_bytes(140_000, seed=4)
    st = host.op_stream_stats(data, 1 << 15, 18)
    assert int(st[2].max()) > 1 << 17
    packed = _host_stats(st, 1)
    cw = host.cap_words_for(2 * len(data) + 4096)
    words = np.zeros((1, cw, 1), np.uint32)
    lens = np.zeros((1, 8, 1), np.int32)
    lanes_lib.host_encode_stats(*map(_ptr, packed), 1, packed[0].shape[1],
                                1, _ptr(words), cw, _ptr(lens))
    pay = host.unpack_group_payloads(words, lens, 1)
    assert pay == [port_native.sqz4_compress_payload(data, 1 << 15)]
    got, plan, _buf, _meta = _decode_lanes(lanes_lib, pay, [len(data)], 18,
                                           1)
    assert b"".join(host.postprocess_decode(*got, pay, [len(data)],
                                            1 << 18)) == data


def test_decoder_binary_test_matches_the_cumulative_count(lanes_lib):
    # floor(diff / rd) >= f0 exactly when diff >= f0 * rd, on random
    # coder states: rd = rng // tot from the divider, diff inside and
    # past the interval (the reference saturates there)
    rng = np.random.default_rng(23)
    n = 200000
    tot = rng.integers(2, 1 << 17, n).astype(np.uint32)
    rg = rng.integers(1 << 17, 1 << 64, n, dtype=np.uint64)
    rd = np.zeros(n, np.uint64)
    lanes_lib.host_div(_ptr(rg), _ptr(tot), n, _ptr(rd))
    np.testing.assert_array_equal(rd, rg // tot.astype(np.uint64))
    f0 = (rng.integers(0, 1 << 62, n, dtype=np.uint64)
          % (tot.astype(np.uint64) - np.uint64(1))) + np.uint64(1)
    top = tot.astype(np.uint64) * rd
    inside = rng.integers(0, 1 << 62, n, dtype=np.uint64) % top
    for diff in (inside, top - np.uint64(1), top, f0 * rd,
                 f0 * rd - np.uint64(1)):
        cum = np.minimum(diff // rd, tot.astype(np.uint64) - np.uint64(1))
        np.testing.assert_array_equal(cum >= f0, diff >= f0 * rd)


@pytest.mark.parametrize("nb", [16, 10])
def test_compaction_lanes_equal_plain_version(lanes_lib, nb):
    rng = np.random.default_rng(nb)
    B, R = 16, 256
    lens = np.zeros((1, 8, B), np.int32)
    lens[0, 0] = rng.integers(0, R * 4 + 1, B)
    lens[0, 0, 3], lens[0, 0, 5] = 0, R * 4
    lens[0, 0, nb:] = 999999                 # inactive lanes: garbage
    words = rng.integers(0, 1 << 32, (1, R, B), dtype=np.uint64).astype(
        np.uint32)
    wt, lt = convert.to_device(words, "cpu"), convert.to_device(lens, "cpu")
    offsets = np.ascontiguousarray(
        sqz4_ref.compact_offsets(lt, nb, R).numpy())
    out = np.zeros(int(offsets[-1]), np.uint32)
    lanes_lib.host_compact(_ptr(words), B, _ptr(offsets), nb, _ptr(out),
                           sqz4_cuda.COMPACT_ROWS)
    np.testing.assert_array_equal(
        out, convert.to_numpy(sqz4_ref.compact_ref(wt, lt, nb)))


@pytest.mark.parametrize("base", [0, 1, 2, 3])
def test_payload_pack_words_equal_plain_version(lanes_lib, base):
    # the data's first byte at each offset in its word; lanes of 0-9
    # bytes and random lengths, one of exactly 4 * pw bytes, oversized,
    # before the data and past its end, three groups, the last short
    rng = np.random.default_rng(base)
    G, lanes, pw, nb = 3, 24, 12, 61
    lens = rng.integers(0, 4 * pw + 3, G * lanes)
    lens[:12] = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 4 * pw, 4 * pw + 1)
    lens[nb:] = 0
    offs = np.zeros(G * lanes, np.int64)
    np.cumsum(lens[:-1] + rng.integers(0, 4, G * lanes - 1),
              out=offs[1:])
    nbytes = int(offs[-1] + lens[-1]) + 5
    offs[12], offs[13] = -2, nbytes - 3
    raw = np.zeros(base + nbytes + 8, np.uint8)
    raw[base:base + nbytes] = rng.integers(0, 256, nbytes)
    data4 = raw[:(base + nbytes + 3) // 4 * 4].view(np.uint32)
    out = np.zeros((G, pw, lanes), np.uint32)
    lanes_lib.host_pack(_ptr(data4), base, nbytes, _ptr(offs),
                        _ptr(lens), G, lanes, pw, _ptr(out))
    want = sqz4_ref.pack_payloads_ref(
        torch.from_numpy(raw[base:base + nbytes].copy()),
        torch.from_numpy(offs).view(G, lanes),
        torch.from_numpy(lens).view(G, lanes), pw)
    np.testing.assert_array_equal(out, convert.to_numpy(want))


@pytest.mark.parametrize("tile_rows", [32, 64])
def test_compaction_tiles_equal_plain_version(coder_lib, tile_rows):
    # 40 lanes (a second lane group of 8), 37 active; word counts of 0,
    # one word, exact multiples of the tile, the whole column and random
    rng = np.random.default_rng(tile_rows)
    B, R, nb = 40, 200, 37
    wc = rng.integers(0, R + 1, B)
    wc[[0, 1, 2, 3, 4, 33]] = (0, 1, tile_rows, 2 * tile_rows, R, R)
    lens = np.zeros((1, 8, B), np.int32)
    lens[0, 0] = np.maximum(4 * wc - rng.integers(0, 4, B), 0)
    lens[0, 0, nb:] = 999999                 # inactive lanes: garbage
    words = rng.integers(0, 1 << 32, (1, R, B), dtype=np.uint64).astype(
        np.uint32)
    wt, lt = convert.to_device(words, "cpu"), convert.to_device(lens, "cpu")
    offsets = np.ascontiguousarray(
        sqz4_ref.compact_offsets(lt, nb, R).numpy())
    out = np.zeros(int(offsets[-1]), np.uint32)
    coder_lib.host_compact(_ptr(words), B, _ptr(offsets), nb, _ptr(out),
                           tile_rows)
    np.testing.assert_array_equal(
        out, convert.to_numpy(sqz4_ref.compact_ref(wt, lt, nb)))
    buf = out.astype(">u4").tobytes()
    assert [buf[a:a + n] for a, n in host.compact_byte_ranges(lens, nb)] \
        == sp.fetch_payloads_compact(jnp.asarray(words), lens, nb,
                                     interpret=True)


@pytest.mark.parametrize("parse", ["exact", "fast"])
def test_bitpacker_lanes_equal_plain_version(lanes_lib, parse):
    blk, lanes = 10, 4
    bs = 1 << blk
    data = _data(bs)
    nb = -(-len(data) // bs)
    words_in, mx = port_native.squeeze_plan_pack(
        data, 10, blk, lanes, 4 * bs + 64, parse=parse)
    ops = np.ascontiguousarray(words_in[:, :int(mx)])
    G, T, _ = ops.shape
    cw = host.cap_words_for(bs + 4096)
    words = np.zeros((G, cw, lanes), np.uint32)
    lens = np.zeros((G, 8, lanes), np.int32)
    assert lanes_lib.host_bitpack(_ptr(ops), G, T, lanes, _ptr(words), cw,
                                  _ptr(lens), squeeze_cuda.TILE_ROWS) == 0
    want = squeeze_ref.bitpack_ref(convert.to_device(ops, "cpu"), cw)
    np.testing.assert_array_equal(words, convert.to_numpy(want[0]))
    np.testing.assert_array_equal(lens, convert.to_numpy(want[1]))
    assert (host.unpack_group_payloads(words, lens, nb)
            == native.blocks_compress(data, 0, 10, blk, parse=parse))


def test_bitpacker_lanes_drop_words_past_the_capacity(lanes_lib):
    rng = np.random.default_rng(3)
    nbs = rng.integers(1, 26, (1, 300, 4)).astype(np.uint32)
    ops = (nbs << 25) | rng.integers(0, 1 << 24, nbs.shape).astype(
        np.uint32) % (np.uint32(1) << nbs)
    cw = 32
    words = np.zeros((1, cw, 4), np.uint32)
    lens = np.zeros((1, 8, 4), np.int32)
    assert lanes_lib.host_bitpack(_ptr(ops), 1, 300, 4, _ptr(words), cw,
                                  _ptr(lens), squeeze_cuda.TILE_ROWS) == 0
    want = squeeze_ref.bitpack_ref(convert.to_device(ops, "cpu"), cw)
    np.testing.assert_array_equal(words, convert.to_numpy(want[0]))
    np.testing.assert_array_equal(lens, convert.to_numpy(want[1]))
    assert (lens[0, 0] > 4 * cw).all()


def _records(rng, nbs):
    """Write records of the bit counts ``nbs`` (0: a zero pad record),
    each with a random value below 2^count."""
    nbs = nbs.astype(np.uint32)
    vals = rng.integers(0, 1 << 25, nbs.shape).astype(np.uint32)
    return (nbs << 25) | (vals & ((np.uint32(1) << nbs) - np.uint32(1)))


def _bitpack_case(case, tile_rows):
    """(records uint32 [2, 300, 40], cap_words) for one synthetic case:
    two groups, a second lane group of 8 lanes, a last tile cut short."""
    rng = np.random.default_rng([tile_rows, len(case)])
    G, T, B = 2, 300, 40
    nbs = rng.integers(1, 26, (G, T, B))
    cw = 256                     # above the longest lane: 300 x 25 bits
    if case == "mixed":          # pads mid-column; columns that end early
        nbs[rng.random(nbs.shape) < 0.25] = 0
        for g, b in zip(*np.nonzero(rng.random((G, B)) < 0.3)):
            nbs[g, rng.integers(0, T):, b] = 0
        nbs[:, :, 5] = 25        # every record straddles or fills words
    elif case == "empty":        # most lanes hold no record
        nbs[:, :, rng.random(B) < 0.7] = 0
        nbs[:, :, [0, 39]] = 0
        nbs[:, :, 1] = 0
        nbs[:, T - 3:, 1] = 7    # only the last tile's last rows
        nbs[:, :, 2] = 0
        nbs[:, :2, 2] = 25       # only the first rows
    elif case == "aligned":      # totals (and tile totals) at 32 and 64
        nbs[:, :, 3] = 16        # every tile ends on a word
        nbs[:, :, 4] = 8         # 2400 bits: a multiple of 32, not 64
        for b in (6, 7):         # random counts, then fill to 32 or 64
            nbs[:, T - 8:, b] = 0
            for g in range(G):
                m = 32 * (b - 5)
                rest = -int(nbs[g, :, b].sum()) % m
                for t in range(T - 8, T):
                    k = min(rest, 25)
                    nbs[g, t, b], rest = k, rest - k
            assert (nbs[:, :, b].sum(1) % (32 * (b - 5)) == 0).all()
    else:                        # "capacity": most lanes past it
        cw = 96                  # 3072 bits
        nbs[:, 123:, 8] = 0      # 123 x 24 bits: inside
        nbs[:, :123, 8] = 24
        nbs[:, 128:, 9] = 0      # 128 x 24 bits: the capacity exactly
        nbs[:, :128, 9] = 24
    return _records(rng, nbs), cw


@pytest.mark.parametrize("case", ["mixed", "empty", "aligned", "capacity"])
@pytest.mark.parametrize("tile_rows", [32, 64])
def test_bitpacker_tiles_equal_plain_version(coder_lib, tile_rows, case):
    # tiles small enough that records straddle tile and word boundaries
    ops, cw = _bitpack_case(case, tile_rows)
    G, T, B = ops.shape
    words = np.zeros((G, cw, B), np.uint32)
    lens = np.zeros((G, 8, B), np.int32)
    assert coder_lib.host_bitpack(_ptr(ops), G, T, B, _ptr(words), cw,
                                  _ptr(lens), tile_rows) == 0
    want = squeeze_ref.bitpack_ref(convert.to_device(ops, "cpu"), cw)
    np.testing.assert_array_equal(words, convert.to_numpy(want[0]))
    np.testing.assert_array_equal(lens, convert.to_numpy(want[1]))
    past = lens[:, 0] > 4 * cw
    assert past.any() == (case == "capacity")
    if case == "capacity":
        assert not past[:, 8:10].any() and (lens[:, 0, 9] == 4 * cw).all()
    if case == "empty":
        assert (lens[:, 0, [0, 39]] == 0).all() and (lens[:, 0, 1:3] > 0).all()


def test_stats_encoder_lanes_equal_plain_version(lanes_lib):
    blk, lanes = 10, 4
    bs = 1 << blk
    data = _data(bs)
    nb = -(-len(data) // bs)
    st = host.op_stream_stats(data, 1 << 10, blk)
    packed = _host_stats(st, lanes)
    G, T, _ = packed[0].shape
    cw = host.cap_words_for(bs + 2048)
    words = np.zeros((G, cw, lanes), np.uint32)
    lens = np.zeros((G, 8, lanes), np.int32)
    lanes_lib.host_encode_stats(*map(_ptr, packed), G, T, lanes,
                                _ptr(words), cw, _ptr(lens))
    want = sqz4_ref.encode_stats_ref(
        *(convert.to_device(a, "cpu") for a in packed), cw)
    np.testing.assert_array_equal(words, convert.to_numpy(want[0]))
    np.testing.assert_array_equal(lens, convert.to_numpy(want[1]))
    assert (host.unpack_group_payloads(words, lens, nb)
            == native.blocks_compress(data, 1, 10, blk))


@pytest.mark.parametrize("name", probe.PROBES)
def test_probe_lanes_equal_plain_version(lanes_lib, name):
    d = probe.inputs()
    a, b = (np.ascontiguousarray(d[k]) if k else None
            for k in probe.ARGS[name])
    out = np.zeros((probe.ROWS if name == "sublane_cumsum" else 1,
                    probe.B), np.uint32)
    assert lanes_lib.host_probe(probe.PROBES.index(name), _ptr(a),
                                _ptr(b) if b is not None else None,
                                _ptr(out), probe.B, a.shape[0]) == 0
    np.testing.assert_array_equal(out, probe.expected(name))
    want = probe.plain(name, *probe.probe_tensors(name, "cpu"))
    np.testing.assert_array_equal(out, convert.to_numpy(want))


# The op-stream and stats-fed encoders on synthetic streams that reach
# every input case, and the coders on a warp of 32 host threads.

@pytest.fixture(params=["lane", "warp"])
def coder_lib(request):
    """The kernels' device functions built with one lane a warp, then with
    32 host threads."""
    return request.getfixturevalue("lanes_lib" if request.param == "lane"
                                   else "warp_lib")


def _encode_ops_both(lib, m, s, cw, seed=None, fresh=-1):
    """The op-stream encoder's lane bodies and its plain version on the
    same inputs (``seed``: the seed column, int32 [610], for the seeded
    mode, every block but ``fresh`` warm)."""
    G, TW, B = m.shape
    words = np.zeros((G, cw, B), np.uint32)
    lens = np.zeros((G, 8, B), np.int32)
    lib.host_encode(_ptr(m), _ptr(s), G, TW, B,
                    None if seed is None else _ptr(seed), fresh,
                    _ptr(words), cw, _ptr(lens))
    want = sqz4_ref.encode_full_ref(
        convert.to_device(m, "cpu"), convert.to_device(s, "cpu"), cw,
        None if seed is None else torch.from_numpy(seed), fresh)
    return (words, lens), [convert.to_numpy(x) for x in want]


def _encode_stats_both(lib, packed, cw):
    G, T, B = packed[0].shape
    words = np.zeros((G, cw, B), np.uint32)
    lens = np.zeros((G, 8, B), np.int32)
    lib.host_encode_stats(*map(_ptr, packed), G, T, B, _ptr(words), cw,
                          _ptr(lens))
    want = sqz4_ref.encode_stats_ref(
        *(convert.to_device(a, "cpu") for a in packed), cw)
    return (words, lens), [convert.to_numpy(x) for x in want]


def _assert_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_encoder_lanes_code_every_op(coder_lib):
    # every op code 0..35 with symbols 0..255 (bits past 31, binary
    # symbols past 1), flushes and pads (36..253, 255) anywhere, blocks
    # of mixed lengths, some ending in the eight flushes
    m, s = synthetic.op_stream(10, 700, seed=21, lanes=5)
    ops = m.astype(">u4").view(np.uint8)
    assert {0, 1, 2, 3, 4, 35, 254, 255} <= set(np.unique(ops).tolist())
    got, want = _encode_ops_both(coder_lib, m, s,
                                 host.cap_words_for(4096))
    _assert_equal(got, want)


@pytest.mark.parametrize("op", [0, 1, 2, 3, 4, 19, 35])
def test_encoder_lanes_code_one_model_in_a_row(coder_lib, op):
    # 64 ops of one model: two windows whose ops all share a model, so
    # each op's statistics count every earlier op of its window
    m, s = synthetic.one_model(op, 64, seed=op)
    got, want = _encode_ops_both(coder_lib, m, s, 64)
    _assert_equal(got, want)


def test_stats_encoder_lanes_code_flushes_and_pads(coder_lib):
    # statistics with flushes and pads mid-stream, runs of flushes longer
    # than a buffer's room, blocks of mixed lengths
    packed = synthetic.stats_stream(10, 900, seed=22, lanes=5)
    tt, sz = packed[2], packed[1]
    assert ((tt != 0) & (sz == 0)).any() and (tt == 0).any()
    got, want = _encode_stats_both(coder_lib, packed,
                                   host.cap_words_for(4096))
    _assert_equal(got, want)


@pytest.mark.parametrize("which", ["ops", "stats"])
def test_encoder_lanes_drop_bytes_past_the_capacity(coder_lib, which):
    # payloads longer than cap_words words: the words past it are dropped
    # and lens counts every byte
    cw = 16
    if which == "ops":
        m, s = synthetic.op_stream(6, 900, seed=23)
        got, want = _encode_ops_both(coder_lib, m, s, cw)
    else:
        got, want = _encode_stats_both(
            coder_lib, synthetic.stats_stream(6, 900, seed=24), cw)
    _assert_equal(got, want)
    assert (got[1][0, 0] > 4 * cw).sum() >= 3


@pytest.mark.parametrize("kind", ["mixed", "random"])
def test_encoder_warp_codes_parsed_blocks(warp_lib, kind):
    # the exact parse's op streams (pseudo-text, runs, zeros, random
    # bytes; or random bytes alone, a flag and a byte an op pair) through
    # the 32-lane windows: the native engine's payloads
    blk, lanes = 10, 4
    bs = 1 << blk
    data = _data(bs) if kind == "mixed" else corpus.random_bytes(
        3 * bs + 100, seed=25)
    nb = -(-len(data) // bs)
    mw, sw, mx = native.sqz4_plan_pack(data, 1 << 10, blk, True, lanes,
                                       host.op_stream_cap(blk))
    rows = -(-int(mx) // 4)
    m, s = (np.ascontiguousarray(a[:, :rows]) for a in (mw, sw))
    got, want = _encode_ops_both(warp_lib, m, s,
                                 host.cap_words_for(bs + 2048))
    _assert_equal(got, want)
    assert (host.unpack_group_payloads(*got, nb)
            == native.blocks_compress(data, 1, 10, blk))


def test_stats_encoder_warp_codes_parsed_statistics(warp_lib):
    blk, lanes = 10, 4
    bs = 1 << blk
    data = _data(bs)
    nb = -(-len(data) // bs)
    packed = _host_stats(host.op_stream_stats(data, 1 << 10, blk), lanes)
    got, want = _encode_stats_both(warp_lib, packed,
                                   host.cap_words_for(bs + 2048))
    _assert_equal(got, want)
    assert (host.unpack_group_payloads(*got, nb)
            == native.blocks_compress(data, 1, 10, blk))


@pytest.mark.parametrize("cut", [0, 3, 100, -1, 9])
def test_token_encoder_warp_equals_plain_version(warp_lib, cut):
    # literal chunks, distance bits a lane each, the pair budget's cuts
    blk, lanes = 10, 4
    data = (corpus.texty(2 << blk, seed=26)
            + corpus.random_bytes(1 << blk, seed=27))
    tt, lt, mx, _ = _tok_inputs(data, blk, lanes)
    t_max = mx + cut if cut < 0 or cut == 9 else cut
    got, want = _encode_tok_both(warp_lib, tt, lt, t_max,
                                 host.cap_words_for((1 << blk) + 2048))
    _assert_equal(got, want)



@pytest.mark.parametrize("cut", [0, 9, -2])
def test_lit_skip_warp_equals_plain_version(warp_lib, cut):
    # the lit_skip lanes on a warp of 32 host threads (the 32-literal
    # windows split over the lanes after each jump; a gang's coder lanes
    # on threads of their own, five blocks: a gang and one of one block)
    tt, lt, mx = _skip_inputs(5, 11, 5, seed=6)
    got, want = _encode_tok_both(warp_lib, tt, lt,
                                 mx + cut if cut <= 0 else cut,
                                 host.cap_words_for((1 << 11) + 2048),
                                 lit_skip=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)

@pytest.mark.parametrize("corrupt", [False, True])
def test_decoder_warp_equals_plain_version(warp_lib, corrupt):
    blk, lanes = 9, 4
    bs = 1 << blk
    data = corpus.texty(2 * bs, seed=28) + corpus.random_bytes(2 * bs,
                                                               seed=29)
    payloads = native.blocks_compress(data, 1, 10, blk)
    if corrupt:
        rng = np.random.default_rng(30)
        for b in range(lanes):
            p = bytearray(payloads[b])
            p[int(rng.integers(0, len(p)))] ^= int(rng.integers(1, 256))
            payloads[b] = bytes(p)
    got, want = _decode_both(warp_lib, payloads, [bs] * lanes, blk, lanes)
    _assert_equal(got, want)
    if not corrupt:
        assert b"".join(host.postprocess_decode(*got, payloads,
                                                [bs] * lanes, bs)) == data


def _warm_seed(kind: str):
    """(seed u32[610], dictionary) of a warm start: the final state and
    the tail of a block coded cold, 16 KiB of pseudo-text (totals at the
    2^14 rescale limit) or 1 KiB of random bytes (byte-model heavy)."""
    block = (corpus.texty(1 << 14, seed=31) if kind == "texty"
             else corpus.random_bytes(1 << 10, seed=32))
    payload = port_native.sqz4_compress_payload(block, 1 << 10)
    _, seed = port_native.sqz4_decompress_payload(payload, len(block),
                                                  return_state=True)
    return seed, block[-(1 << 10):]


@pytest.mark.parametrize("parse", ["exact", "fast"])
def test_seeded_encoder_lanes_equal_plain_version(coder_lib, parse):
    # the device pass of a warm container: blocks 1+ planned against block
    # 0's tail and coded from its final state, block 0 cold; the payloads
    # are the native seeded codec's
    blk, lanes = 10, 4
    bs = 1 << blk
    data = _data(bs)
    nb = -(-len(data) // bs)
    cap = host.op_stream_cap(blk)
    if parse == "exact":
        mw, sw, mx, seed = port_native.sqz4_plan_pack(
            data, 1 << 10, blk, True, lanes, cap, warm=True)
        rows = -(-int(mx) // 4)
        m, s = (np.ascontiguousarray(a[:, :rows]) for a in (mw, sw))
    else:
        m8, s8, mx, seed = port_native.sqz4_fast_plan(
            data, 1 << 10, blk, True, cap, warm=True)
        rows = -(-int(mx) // 4)
        m, s = (convert.to_numpy(sqz4_cuda.pack_ops_words(x)) for x in
                convert.fast_plan_inputs(m8, s8, lanes, rows, "cpu"))
    got, want = _encode_ops_both(coder_lib, m, s,
                                 host.cap_words_for(bs + 2048 + bs // 4),
                                 host.seed_column(seed), 0)
    _assert_equal(got, want)
    payloads = host.unpack_group_payloads(*got, nb)
    assert payloads[0] == port_native.sqz4_compress_payload(
        data[:bs], 1 << 10, parse=parse)
    for b in range(1, nb):
        assert payloads[b] == port_native.sqz4_compress_payload(
            data[b * bs:(b + 1) * bs], 1 << 10, seed=seed,
            dictionary=data[:bs], parse=parse), b


@pytest.mark.parametrize("kind", ["texty", "random"])
def test_seeded_decoder_lanes_equal_plain_version(coder_lib, kind):
    # blocks coded from a foreign seed whose totals are anything up to
    # 2^14 (each model's reciprocal window starts there) and matching into
    # the dictionary: records equal the plain version's, and the assembly
    # restores the blocks
    blk, lanes = 10, 4
    bs = 1 << blk
    seed, dictionary = _warm_seed(kind)
    data = _data(bs)[:lanes * bs - 300]
    parts = [data[o:o + bs] for o in range(0, len(data), bs)]
    payloads = [port_native.sqz4_compress_payload(
        p, 1 << 10, seed=seed, dictionary=dictionary) for p in parts]
    sizes = [len(p) for p in parts]
    got, want = _decode_both(coder_lib, payloads, sizes, blk, lanes,
                             host.seed_column(seed), len(dictionary))
    _assert_equal(got, want)
    outs = host.postprocess_decode(*got, payloads, sizes, bs, seed=seed,
                                   dictionary=dictionary)
    assert b"".join(outs) == data


def test_seeded_decoder_lanes_flag_corrupt_streams_like_plain_version(
        coder_lib):
    blk, lanes = 9, 4
    bs = 1 << blk
    seed, dictionary = _warm_seed("texty")
    data = corpus.texty(lanes * bs, seed=33)
    rng = np.random.default_rng(34)
    payloads = []
    for b in range(lanes):
        p = bytearray(port_native.sqz4_compress_payload(
            data[b * bs:(b + 1) * bs], 1 << 10, seed=seed,
            dictionary=dictionary))
        p[int(rng.integers(0, len(p)))] ^= int(rng.integers(1, 256))
        payloads.append(bytes(p))
    got, want = _decode_both(coder_lib, payloads, [bs] * lanes, blk, lanes,
                             host.seed_column(seed), len(dictionary))
    _assert_equal(got, want)
    assert got[3][0, 4].any()


# The resident restore's cell assembly (csrc/sqz4_cell.cu): its lane body
# on the decoder's outputs (from the decoder's lane bodies) against the
# plain version, blocks and bad flags on every lane, tolerance 0.

def _match(length, dist):
    return length | (1 << 8) | (dist.bit_length() << 9) | (dist << 16)


def _lit_skip_payloads(lib, rows, toks, blk):
    """Raw blocks [n, bs] u8 and their token rows (lists, EOS appended) ->
    payloads from the lit_skip token encoder's lane bodies."""
    n, bs = rows.shape
    cw = resident.rle_group_args(blk)["cap_words"]
    tt = max(96, max(map(len, toks)) + 1)
    tk = np.zeros((1, n, tt), np.uint32)
    for b, row in enumerate(toks):
        tk[0, b, :len(row) + 1] = row + [resident.EOS_TOKEN]
    words = np.zeros((1, cw, n), np.uint32)
    lens = np.zeros((1, 8, n), np.int32)
    lib.host_encode_tok(_ptr(tk), tt, _ptr(np.ascontiguousarray(rows[None])),
                        bs, 1, n, bs + 64, _ptr(words), cw, _ptr(lens), 1)
    return host.unpack_group_payloads(words, lens, n)


# the tile body's geometries: (lanes a CTA, literal cells a chunk); 0, 0
# is the kernel's
CELL_GEOMS = {"tile1-chunk1": (1, 1), "tile4-chunk2": (4, 2),
              "kernel": (0, 0)}


def _cell_both(lib, payloads, sizes, blk, geom, dec_lib=None, flags=None):
    """One group of payloads through the decoder's lane bodies (of
    ``dec_lib``, default ``lib``), then the cell assembly's tile bodies at
    geometry ``geom`` and its plain version: ((blocks, bad), (blocks, bad))
    as numpy. ``flags`` {lane: counts row} sets that decoder count (err
    row 4, ovf row 6) before the assembly."""
    bs = 1 << blk
    lanes = len(payloads)
    (lit, tok, mrec, counts), plan, _b, _m = _decode_lanes(
        dec_lib or lib, payloads, sizes, blk, lanes)
    for lane, row in (flags or {}).items():
        counts[0, row, lane] = 1
    szs = np.asarray(sizes, np.int32)
    blocks = np.full((lanes, bs), 0xEE, np.uint8)
    bad = np.full((lanes,), 7, np.uint8)
    tile, chunk = CELL_GEOMS[geom]
    if tile == 0:
        tile, chunk = _kernel_geom()
    assert lib.host_cell(_ptr(lit), plan["lw"], _ptr(tok), plan["tw"],
                         _ptr(mrec), plan["mw"], _ptr(counts), _ptr(szs),
                         lanes, bs // resident.CELL, _ptr(blocks),
                         _ptr(bad), tile, chunk) == 0
    wb, wbad = resident.assemble_cells(
        *(convert.to_device(a, "cpu") for a in (lit, tok, mrec, counts)),
        torch.from_numpy(szs.astype(np.int64)), bs)
    return (blocks, bad.astype(bool)), (wb.numpy(), wbad.numpy())


def _kernel_geom():
    """The kernel's (lanes a CTA, literal cells a chunk), from its
    source's defaults."""
    text = (CSRC / "sqz4_cell.cu").read_text()
    return tuple(int(text.split(f"#define SQZ_CELL_{k} ")[1].split()[0])
                 for k in ("TILE", "CHUNK"))


def _crafted_cells():
    """1 KiB blocks of random nonzero cells with hand-made token rows: far
    copies of a literal source (restores), of a periodic source (flagged),
    of a periodic all-zero source (restores), and matches the cell model
    rejects (a dist that is not a power of two, a short match, a far dist
    off the cell grid, a match in a short last cell)."""
    rng = np.random.default_rng(41)
    L, M = 128, _match     # a literal cell's token, a match token
    cases = []

    def case(edits, row, size=1024):
        cells = rng.integers(1, 256, (8, 128), dtype=np.uint8)
        for i, j in edits:
            cells[i] = 0 if j is None else cells[j]
        cases.append((cells.reshape(-1), row, size))

    case([(3, 1)], [L, L, L, M(128, 256), L, L, L, L])
    case([(1, 0), (3, 1)], [L, M(128, 128), L, M(128, 256), L, L, L, L])
    case([(1, None), (2, None), (4, None)],
         [L, L, M(128, 128), L, M(128, 256), L, L, L])
    case([], [L, L, M(128, 96), L, L, L, L, L])
    case([], [L, M(64, 128), 64, L, L, L, L, L, L])
    case([], [L, L, M(128, 200), L, L, L, L, L])
    case([], [L] * 7 + [M(104, 128)], size=1000)
    case([(5, 2)], [L, L, L, L, L, M(128, 384), L, L])
    return cases


@pytest.mark.parametrize("geom", ["tile1-chunk1", "kernel"])
def test_cell_assembly_lanes_on_crafted_far_copies(coder_lib, geom):
    cases = _crafted_cells()
    rows = np.stack([c[0] for c in cases])
    sizes = [c[2] for c in cases]
    payloads = _lit_skip_payloads(coder_lib, rows, [c[1] for c in cases], 10)
    got, want = _cell_both(coder_lib, payloads, sizes, 10, geom)
    _assert_equal(got, want)
    assert want[1].tolist() == [False, True, False, True, True, True, True,
                                False]
    for b in np.nonzero(~want[1])[0]:
        assert got[0][b].tobytes() == rows[b].tobytes()
        assert port_native.sqz4_decompress_payload(
            payloads[b], 1024) == rows[b].tobytes()


def _cell_mix(lib, blk):
    """Cell-parsed payloads of the resident mix and of RLE-shaped blocks,
    the last block short, beside host-parsed ones (not cell-parsed) and a
    corrupt one: (payloads, sizes, data, the cell-parsed count)."""
    bs = 1 << blk
    text = corpus.texty(8 * bs, seed=43)
    parts = [bytes(bs), text[:bs], bytes(bs // 2) + text[:bs // 2],
             (b"x" * 127 + b"y") * (bs // 128), b"abcd" * (bs // 4),
             (text[:32] * (bs // 32)), text[:bs // 2] + text[:bs // 2]]
    data = b"".join(parts) + synthetic.resident_mix(
        10, blk, seed=44, tail=bs - 100)
    nb = -(-len(data) // bs)
    rows = np.zeros((nb, bs), np.uint8)
    rows.reshape(-1)[:len(data)] = np.frombuffer(data, np.uint8)
    sizes = [min(bs, len(data) - b * bs) for b in range(nb)]
    tt = resident.rle_group_args(blk)["Tt"]
    toks, _pairs = resident.rle_plan_device(
        torch.from_numpy(rows), torch.tensor(sizes, dtype=torch.int64), tt)
    tk = toks.view(torch.int32)[0].numpy().view(np.uint32)
    payloads = _lit_skip_payloads(
        lib, rows, [list(map(int, r[:list(r).index(resident.EOS_TOKEN)]))
                    for r in tk], blk)
    for b in range(nb):
        assert port_native.sqz4_decompress_payload(
            payloads[b], sizes[b]) == rows[b, :sizes[b]].tobytes()
    hosted = [port_native.sqz4_compress_payload(text[o:o + bs], 1 << 15)
              for o in range(bs, 5 * bs, bs)]
    bad = bytearray(payloads[1])
    bad[len(bad) // 2] ^= 0x5A
    return (payloads + hosted + [bytes(bad)], sizes + [bs] * 4 + [sizes[1]],
            rows, nb)


@pytest.mark.parametrize("blk", [7, 10])
@pytest.mark.parametrize("geom", ["tile4-chunk2", "kernel"])
def test_cell_assembly_lanes_equal_plain_version(coder_lib, blk, geom):
    payloads, sizes, rows, nb = _cell_mix(coder_lib, blk)
    got, want = _cell_both(coder_lib, payloads, sizes, blk, geom)
    _assert_equal(got, want)
    assert not want[1][:nb].any() and want[1][-1]
    if blk >= 10:
        assert want[1][nb:].all()
    np.testing.assert_array_equal(got[0][:nb], rows)



def _expand(spec, bs, rng):
    """Cells by ``spec`` (("L",) a random literal cell, ("L", n) a literal
    run of n bytes, ("M", d) a len-128 match at dist d, ("M", d, n) one of
    n bytes) -> (the block [bs] u8, the token row, the size): the bytes an
    LZ77 decode of the tokens gives."""
    out, toks = [], []
    for cell in spec:
        if cell[0] == "M":
            n = cell[2] if len(cell) > 2 else 128
            for _ in range(n):
                out.append(out[-cell[1]])
            toks.append(_match(n, cell[1]))
        else:
            n = cell[1] if len(cell) > 1 else 128
            out += rng.integers(1, 256, n).tolist()
            toks.append(n)
    row = np.zeros(bs, np.uint8)
    row[:len(out)] = out
    return row, toks, len(out)


def _cell_lanes(lib, lanes_lib, specs, blk, geom, flags=None):
    """Blocks made by ``specs`` through the lit_skip encoder and the
    decoder (one-lane bodies), then the cell assembly of ``lib`` at
    ``geom`` against its plain version, blocks and flags equal: (got,
    want, rows, sizes)."""
    rng = np.random.default_rng(len(specs) * 131 + blk)
    made = [_expand(sp, 1 << blk, rng) for sp in specs]
    rows = np.stack([m[0] for m in made])
    sizes = [m[2] for m in made]
    payloads = _lit_skip_payloads(lanes_lib, rows, [m[1] for m in made], blk)
    got, want = _cell_both(lib, payloads, sizes, blk, geom, lanes_lib, flags)
    _assert_equal(got, want)
    return got, want, rows, sizes


def _restored(got, want, rows, sizes, lanes):
    """The lanes restore their blocks (zeros past the size), unflagged."""
    for b in lanes:
        assert not want[1][b]
        assert got[0][b, :sizes[b]].tobytes() == rows[b, :sizes[b]].tobytes()
        assert not got[0][b, sizes[b]:].any()


L_ = ("L",)


def M_(d, n=128):
    return ("M", d, n)


def test_cell_assembly_lanes_walk_long_runs(coder_lib, lanes_lib):
    # runs of match cells past the 32-bit token window, runs of literal
    # cells past a warp's ballot, and alternations: 64 cells a block
    specs = [[L_] + [M_(1)] * 45 + [L_] * 18,
             [L_] * 40 + [M_(4)] * 24,
             [L_, M_(2)] * 16 + [L_, L_, M_(256), M_(384)] * 8,
             [L_] * 4 + [M_(512)] + [M_(128)] * 39 + [L_] * 20,
             [L_] * 33 + [M_(32), L_] * 15 + [M_(128)],
             # match cells on a literal cell of the lane's last chunk
             [L_] * 3 + [M_(1)] * 61]
    got, want, rows, sizes = _cell_lanes(coder_lib, lanes_lib, specs, 13,
                                         "tile4-chunk2")
    _restored(got, want, rows, sizes, range(len(specs)))
    # 256 cells: a lane's four token words of a scan step all ones
    specs = [[L_] + [M_(1)] * 255, [L_] * 3 + [M_(128)] * 200 + [L_] * 53]
    got, want, rows, sizes = _cell_lanes(coder_lib, lanes_lib, specs, 15,
                                         "kernel")
    _restored(got, want, rows, sizes, range(len(specs)))


def test_cell_assembly_lanes_fill_every_period(coder_lib, lanes_lib):
    # a lane a dist d of 1..128: periodic cells at d, chained with periods
    # 128 and d / 2 (periods compose to the least); the cell model takes
    # the powers of two and flags the other dists
    specs = [[L_, M_(d), M_(128), M_(max(d // 2, 1)), L_, L_, M_(d), M_(d)]
             for d in range(1, 129)]
    got, want, rows, sizes = _cell_lanes(coder_lib, lanes_lib, specs, 10,
                                         "kernel")
    pow2 = [d - 1 for d in range(1, 129) if d & (d - 1) == 0]
    _restored(got, want, rows, sizes, pow2)
    assert want[1].sum() == 128 - len(pow2)


def test_cell_assembly_lanes_on_short_blocks(coder_lib, lanes_lib):
    # sizes that are not whole cells, below the block size; the last lane
    # has a match in its short last cell, which is no cell match
    specs = [[L_] * 7 + [("L", 104)], [L_, ("L", 2)], [("L", 1)],
             [L_, M_(8), ("L", 127)], [L_, M_(1), M_(1), M_(384), ("L", 5)],
             [("L", 77)], [L_, M_(64), M_(64), L_, L_, ("L", 100)],
             [L_, M_(1, 64)]]
    got, want, rows, sizes = _cell_lanes(coder_lib, lanes_lib, specs, 10,
                                         "tile4-chunk2")
    assert all(s % 128 and s < 1024 for s in sizes)
    _restored(got, want, rows, sizes, range(len(specs) - 1))
    assert want[1][-1]


def test_cell_assembly_lanes_flag_each_bad_cause(coder_lib, lanes_lib):
    # lanes 0-1 restore; then a dist off the cell grid, a far copy of a
    # nonzero periodic cell, a match inside a literal cell (the walk's
    # token count misses ntok), a short match at a cell start, and the
    # decoder's err and ovf flags on good streams
    good = [L_, L_, M_(4), L_, M_(384), L_, L_, L_]
    specs = [good, [L_, M_(1), M_(256)] + [L_] * 5,
             [L_, L_, M_(200)] + [L_] * 5,
             [L_, M_(2), L_, M_(256)] + [L_] * 4,
             [("L", 64), M_(64, 64)] + [L_] * 7,
             [L_, M_(1, 64), ("L", 64)] + [L_] * 6,
             good, good]
    got, want, rows, sizes = _cell_lanes(coder_lib, lanes_lib, specs, 10,
                                         "kernel", flags={6: 4, 7: 6})
    assert sizes == [1024] * len(specs)
    assert want[1].tolist() == [False, False] + [True] * 6
    _restored(got, want, rows, sizes, [0, 1])


def test_probe_batch_equals_plain_version(lanes_lib):
    # the fourteen probes in one fused launch body, a CTA each
    d = probe.inputs()
    names = probe.PROBES
    ins = [[np.ascontiguousarray(d[k]) if k else None
            for k in probe.ARGS[name]] for name in names]
    outs = [np.zeros((probe.ROWS if name == "sublane_cumsum" else 1,
                      probe.B), np.uint32) for name in names]
    n = len(names)

    def arr(ctype, vals):
        return (ctype * n)(*vals)

    vp = ctypes.c_void_p
    assert lanes_lib.host_probe_batch(
        n, arr(ctypes.c_int, [probe.PROBES.index(k) for k in names]),
        arr(ctypes.c_int, [a.shape[0] for a, _b in ins]),
        arr(vp, [a.ctypes.data for a, _b in ins]),
        arr(vp, [b.ctypes.data if b is not None else None
                 for _a, b in ins]),
        arr(vp, [o.ctypes.data for o in outs]), probe.B) == 0
    for name, out in zip(names, outs):
        np.testing.assert_array_equal(out, probe.expected(name))
        want = probe.plain(name, *probe.probe_tensors(name, "cpu"))
        np.testing.assert_array_equal(out, convert.to_numpy(want))


# The model statistics kernel's passes (count_chunk, the base states of
# sqz4_ref.chunk_bases, stats_chunk) and its plain version against the
# native per-block loop (``sqz4_host.op_stats``: sqz4_model_stats with
# the flush marks), element for element.

CHUNK = sqz4_ref.MODEL_CHUNK_OPS
MODEL_LANES = 4   # lanes a group: the synthetic cases' five blocks fill two


def _planned(data, blk, win, warm=False):
    """The exact parse's op streams of ``data`` as the route uploads them:
    (m, s [n, rows] u32, the native seed or None, op_stats' statistics
    [n, T] each); the warm pass without block 0."""
    streams = host.exact_op_streams(data, 1 << win, blk, True, warm)
    mw, sw, mx, seed = streams
    rows, first = -(-mx // 4), int(warm)
    want = [w[first:] for w in host.op_stats(streams)]
    return (*(np.ascontiguousarray(w[first:, :rows, 0]) for w in (mw, sw)),
            seed, want)


def _synthetic(lengths, seed, model=None):
    """``synthetic.planned_streams`` as ``_planned`` returns them."""
    m, s = synthetic.planned_streams(lengths, seed, model)
    t = 4 * m.shape[1]
    return m, s, None, list(host.op_stats((m[..., None], s[..., None], t,
                                           None)))


MODEL_CASES = {
    # two blocks of pseudo-text at 1 MiB blocks, the second short
    "texty-20": lambda: _planned(corpus.texty((1 << 20) + (1 << 17),
                                              seed=41), 20, 15),
    # one block of random bytes: literals, a flag and a byte an op pair
    "random-18": lambda: _planned(corpus.random_bytes(1 << 18, seed=42),
                                  18, 15),
    # the warm pass: blocks 1+ from block 0's final state
    "warm": lambda: _planned(_data(1 << 10), 10, 10, warm=True),
    "shorter-than-a-chunk": lambda: _synthetic(
        [CHUNK - 37, 0, 1, 900, CHUNK - 40], 43),
    "one-chunk": lambda: _synthetic([CHUNK, 17, CHUNK - 1, 5, 3000], 44),
    "one-past-a-chunk": lambda: _synthetic([CHUNK, CHUNK + 1, 9, 0, 4], 45),
    # every coded op of the byte model: each window's ops share it
    "one-model": lambda: _synthetic([CHUNK + 100, 70, 33, 0, 1], 46,
                                    model=2),
}


def _model_inputs(case):
    m, s, seed, want = MODEL_CASES[case]()
    col = (None if seed is None
           else torch.from_numpy(host.seed_column(seed)))
    return m, s, col, want


def _model_stats_host(lib, m, s, col, sel=None):
    """The kernel's two passes on the host harness ``lib``: the statistics
    [G, T, MODEL_LANES] of the chunks in ``sel`` (default all)."""
    n, rows = m.shape
    chunks = -(-4 * rows // CHUNK)
    hist = np.zeros((n, chunks, sqz4_ref.SEED_WORDS), np.int32)
    lib.host_model_hist(_ptr(m), _ptr(s), n, rows, _ptr(hist))
    base = np.ascontiguousarray(
        sqz4_ref.chunk_bases(torch.from_numpy(hist), col).numpy())
    out = np.zeros((3, -(-n // MODEL_LANES), 4 * rows, MODEL_LANES),
                   np.uint32)
    sel_a = np.asarray(sel if sel is not None else [], np.int32)
    lib.host_model_stats(_ptr(m), _ptr(s), n, rows, MODEL_LANES, _ptr(base),
                         _ptr(sel_a), -1 if sel is None else len(sel),
                         *(_ptr(out[k]) for k in range(3)))
    return out


@pytest.mark.parametrize("impl", ["lane", "warp", "plain"])
@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_stats_equal_native(request, case, impl):
    # each chunk's counts, the base states summed over the chunks before
    # it and each chunk's statistics from them (on a warp of one lane and
    # of 32 host threads; there, past two chunks, the last chunk alone,
    # from the counts of all before it), and the plain version, against
    # the native per-block walk
    m, s, col, want = _model_inputs(case)
    n, rows = m.shape
    T = 4 * rows
    chunks = -(-T // CHUNK)
    sel = None
    if impl == "plain":
        got = np.stack([convert.to_numpy(x) for x in sqz4_ref.model_stats_ref(
            *(convert.to_device(x, "cpu") for x in (m, s)), MODEL_LANES,
            col)])
    else:
        lib = request.getfixturevalue("lanes_lib" if impl == "lane"
                                      else "warp_lib")
        assert lib.host_model_chunk_ops() == CHUNK
        if impl == "warp" and chunks > 2:
            sel = [chunks - 1]
        got = _model_stats_host(lib, m, s, col, sel)
    lanes = got.transpose(0, 1, 3, 2).reshape(3, -1, T)
    cols = np.zeros(T, bool)
    for c in range(chunks) if sel is None else sel:
        cols[c * CHUNK:(c + 1) * CHUNK] = True
    for k in range(3):
        np.testing.assert_array_equal(lanes[k, :n][:, cols],
                                      want[k][:, cols])
    assert not lanes[:, n:].any()
