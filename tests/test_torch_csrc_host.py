"""The CUDA kernels' lane bodies, compiled for the host, against the plain
PyTorch versions.

``csrc/sqz4_encode.cu`` and ``csrc/sqz4_decode.cu`` keep each block's
coder in a device function of plain C++ (the kernels and launchers sit
under ``__CUDACC__``), and a thread shares nothing with its neighbours.
So a host C++ compiler can build the lane bodies as they are, and running
them one lane after another computes what the kernel computes. This
checks the kernel source's arithmetic on a machine with no card; the
card itself is checked by chip_smoke.py and tests/test_torch_cuda.py.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from sqz_tpu import native
from sqz_tpu.utils import corpus
from sqz_tpu_torch import convert
from sqz_tpu_torch.ops import sqz4_host as host, sqz4_ref

# the plain versions step over small tensors: one intra-op thread each,
# so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "sqz_tpu_torch" / "csrc"

HARNESS = r"""
#define SQZ_DEVICE inline
#define __clzll(x) __builtin_clzll(x)
#include <vector>
#include "sqz4_encode.cu"
#include "sqz4_decode.cu"

extern "C" void host_encode(const uint32_t* m, const uint32_t* s, int G,
                            int TW, int B, uint32_t* words, int cw,
                            int32_t* lens) {
    std::vector<int> tab(sqz4::kTableWords);
    for (long long g = 0; g < G; ++g)
        for (long long b = 0; b < B; ++b)
            sqz4::encode_lane(m + g * TW * B + b, s + g * TW * B + b, TW, B,
                              words + g * cw * B + b, cw,
                              lens + g * 8 * B + b, tab.data(), 1);
}

extern "C" void host_decode(const uint32_t* p, const int32_t* meta, int G,
                            int pw, int B, int t_max, uint32_t* lit, int lw,
                            uint32_t* tok, int tw, uint32_t* mrec, int mw,
                            int32_t* counts) {
    std::vector<int> tab(sqz4::kTableWords);
    for (long long g = 0; g < G; ++g)
        for (long long b = 0; b < B; ++b)
            sqz4::decode_lane(p + g * pw * B + b, pw, meta + g * 8 * B + b,
                              B, t_max, lit + g * lw * B + b, lw,
                              tok + g * tw * B + b, tw,
                              mrec + g * mw * B + b, mw,
                              counts + g * 8 * B + b, tab.data(), 1);
}
"""


@pytest.fixture(scope="module")
def lanes_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("csrc_host")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libsqz4host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-Wall", "-Wextra", "-Werror",
                    "-shared", "-fPIC", f"-I{CSRC}", "-o", str(so),
                    str(d / "harness.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_encode.argtypes = [p, p, i, i, i, p, i, p]
    lib.host_decode.argtypes = [p, p, i, i, i, i, p, i, p, i, p, i, p]
    return lib


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


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
    lanes_lib.host_encode(_ptr(m), _ptr(s), G, rows, lanes, _ptr(words), cw,
                          _ptr(lens))
    want = sqz4_ref.encode_full_ref(torch.from_numpy(m.view(np.int32)).view(
        torch.uint32), torch.from_numpy(s.view(np.int32)).view(torch.uint32),
        cw)
    np.testing.assert_array_equal(words, convert.to_numpy(want[0]))
    np.testing.assert_array_equal(lens, convert.to_numpy(want[1]))
    assert (host.unpack_group_payloads(words, lens, nb)
            == native.blocks_compress(data, 1, 10, blk))


def _decode_both(lib, payloads, sizes, blk, lanes):
    plan = host.plan_decode_dispatch(len(payloads), blk, lanes=lanes)
    buf, meta = host.pack_decode_chunk(payloads, sizes, lanes, plan["G"],
                                       plan["Pw"])
    G, pw = plan["G"], plan["Pw"]
    lw, tw, mw, t_max = plan["lw"], plan["tw"], plan["mw"], plan["t_max"]
    got = [np.zeros((G, n, lanes), np.uint32) for n in (lw, tw, mw)]
    got.append(np.zeros((G, 8, lanes), np.int32))
    lib.host_decode(_ptr(buf), _ptr(meta), G, pw, lanes, t_max,
                    _ptr(got[0]), lw, _ptr(got[1]), tw, _ptr(got[2]), mw,
                    _ptr(got[3]))
    pt, mt = convert.decoder_inputs(buf, meta, "cpu")
    want = [convert.to_numpy(a) for a in sqz4_ref.decode_ref(
        pt, mt, t_max, lw, tw, mw)]
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
