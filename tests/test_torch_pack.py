"""The decoder's payload packing on the card (``sqz4_cuda.pack_payloads``,
``csrc/sqz4_pack.cu``) through its plain version on the CPU
(``sqz4_ref.pack_payloads_ref``), against the host packer it replaces on
the decoder's routes (``native.sqz4_pack_payloads``), word for word; the
uploads that feed it and the restore around it. The kernel itself is
held against the plain version on the card (``tests/test_torch_cuda.py``)
and its word arithmetic on the host (``tests/test_torch_csrc_host.py``).
"""

import numpy as np
import pytest
import torch

import sqz_tpu_torch
from sqz_tpu_torch import native
from sqz_tpu_torch.formats import container as sqzt
from sqz_tpu_torch.formats.constants import SQZT_FORMAT_SQZ4
from sqz_tpu_torch.ops import resident, sqz4_cuda
from sqz_tpu_torch.utils import corpus

CPU = torch.device("cpu")


def _payloads(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]


def _host_words(payloads, lanes, groups, pw):
    """The native packer's words, oversized lanes empty, padded to
    ``groups`` groups."""
    fit = [p if len(p) <= 4 * pw else b"" for p in payloads]
    words = native.sqz4_pack_payloads(fit, lanes, pw)
    pad = np.zeros((groups - words.shape[0],) + words.shape[1:], np.uint32)
    return np.concatenate([words, pad])


def _laid_out(payloads, lanes, groups, gap):
    """The payloads in one buffer, ``gap`` junk bytes before each (so
    that odd gaps start them off word boundaries) -> (data, offsets,
    lengths) tensors, lanes past the list empty."""
    rng = np.random.default_rng(gap)
    parts, offs = [], []
    pos = 0
    for p in payloads:
        parts += [rng.integers(0, 256, gap, dtype=np.uint8).tobytes(), p]
        offs.append(pos + gap)
        pos += gap + len(p)
    data = torch.frombuffer(bytearray(b"".join(parts) + b"\xEE" * 3),
                            dtype=torch.uint8)
    n = groups * lanes
    offsets = torch.zeros(n, dtype=torch.int64)
    lengths = torch.zeros(n, dtype=torch.int64)
    offsets[:len(payloads)] = torch.tensor(offs, dtype=torch.int64)
    lengths[:len(payloads)] = torch.tensor([len(p) for p in payloads],
                                           dtype=torch.int64)
    return data, offsets.view(groups, lanes), lengths.view(groups, lanes)


def _words(t):
    return t.view(torch.int32).numpy().view(np.uint32)


# (lanes, groups, pw, payload lengths): lengths 0-4 and odd sizes, a
# payload of exactly 4 * pw bytes, an oversized one, a last group with
# fewer payloads than lanes, one group and three
CASES = {
    "short": (8, 1, 8, [0, 1, 2, 3, 4, 5, 6, 7]),
    "odd": (8, 1, 8, [9, 11, 13, 17, 19, 23, 29, 31]),
    "full": (4, 1, 8, [32, 31, 0, 32]),
    "oversized": (4, 1, 8, [5, 33, 32, 40]),
    "short_last_group": (8, 3, 6, [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
                                   13, 14, 15, 16, 17, 18, 19, 20, 21]),
    "one_lane_of_three_groups": (32, 3, 5, [20] * 64 + [3]),
    "random": (40, 3, 40, None),
}


@pytest.mark.parametrize("gap", [0, 1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_pack_equals_the_native_packer(case, gap):
    lanes, groups, pw, lens = CASES[case]
    if lens is None:
        lens = np.random.default_rng(gap).integers(
            0, 4 * pw + 2, groups * lanes - 7).tolist()
    payloads = _payloads(lens, seed=len(lens) + gap)
    data, offsets, lengths = _laid_out(payloads, lanes, groups, gap)
    got = sqz4_cuda.pack_payloads(data, offsets, lengths, pw)
    assert got.dtype == torch.uint32 and got.shape == (groups, pw, lanes)
    np.testing.assert_array_equal(
        _words(got), _host_words(payloads, lanes, groups, pw))


def test_lanes_outside_the_data_are_empty():
    payloads = _payloads([7, 12, 9, 4], seed=3)
    data, offsets, lengths = _laid_out(payloads, 4, 1, 1)
    n = data.shape[0]
    offsets[0, 1], offsets[0, 2] = -1, n - 4   # before it; past its end
    got = _words(sqz4_cuda.pack_payloads(data, offsets, lengths, 4))
    want = _host_words([payloads[0], b"", b"", payloads[3]], 4, 1, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("groups", [1, 3])
def test_upload_lays_the_payloads_back_to_back(groups):
    lanes = 8
    payloads = _payloads([3, 0, 17, 4, 1] * groups + [2, 9], seed=groups)
    data, offsets, lengths = sqz4_cuda.upload_payloads(payloads, groups,
                                                       lanes, CPU)
    assert data.numpy().tobytes() == b"".join(payloads)
    assert offsets.shape == lengths.shape == (groups, lanes)
    lens = lengths.reshape(-1).tolist()
    offs = offsets.reshape(-1).tolist()
    assert lens == [len(p) for p in payloads] + [0] * (
        groups * lanes - len(payloads))
    raw = data.numpy().tobytes()
    assert [raw[o:o + n] for o, n in zip(offs, lens)][:len(payloads)] \
        == payloads
    pw = 5
    np.testing.assert_array_equal(
        _words(sqz4_cuda.pack_payloads(data, offsets, lengths, pw)),
        _host_words(payloads, lanes, groups, pw))


def test_pack_requests_are_checked():
    data, offsets, lengths = sqz4_cuda.upload_payloads(
        _payloads([5, 6], seed=1), 1, 4, CPU)
    for args in ((data.to(torch.int32), offsets, lengths, 4),
                 (data, offsets.to(torch.int32), lengths, 4),
                 (data, offsets, lengths[:, :2], 4),
                 (data, offsets.reshape(-1), lengths.reshape(-1), 4),
                 (data, offsets, lengths, 0)):
        with pytest.raises(ValueError):
            sqz4_cuda.pack_payloads(*args)


def test_fit_payload_group_matches_the_host_pack():
    # the card pack's lanes (fit_payload_group) are the host pack's
    # (pack_payload_group): its reference on the decoder's routes
    payloads = _payloads([40, 7, 300, 0, 33], seed=9)
    sizes = [64, 64, 64, 64, 50]
    fit, plens, szs, over, pw = resident.fit_payload_group(payloads, sizes,
                                                           64, 8)
    buf, hplens, hszs, hover = resident.pack_payload_group(payloads, sizes,
                                                           64, 8)
    assert over.tolist() == [False, False, True] + [False] * 5
    np.testing.assert_array_equal(plens, hplens)
    np.testing.assert_array_equal(szs, hszs)
    np.testing.assert_array_equal(over, hover)
    data, offsets, lengths = sqz4_cuda.upload_payloads(fit, 1, 8, CPU)
    np.testing.assert_array_equal(lengths[0].numpy(), plens)
    np.testing.assert_array_equal(
        _words(sqz4_cuda.pack_payloads(data, offsets, lengths, pw)), buf)


def test_restore_sends_an_oversized_lane_to_the_host():
    # a payload longer than the decoder buffer (here padded past it: the
    # host codec ignores the tail) packs as an empty lane; the decoder
    # flags it and the host codec restores it
    data = corpus.texty(3000, seed=4) + bytes(1096)
    bs = 1024
    payloads = [native.sqz4_compress_payload(data[o:o + bs], 1 << 15)
                for o in range(0, len(data), bs)]
    payloads[1] += bytes(6000)
    blob = sqzt.pack(SQZT_FORMAT_SQZ4, 15, 10, len(data), payloads, None)
    before = dict(resident.route_lanes)
    out = sqz_tpu_torch.decompress_resident(blob, lanes=32, device="cpu")
    assert out.numpy().tobytes() == data
    moved = {k: resident.route_lanes[k] - before[k] for k in before}
    assert moved["host"] == 1 and sum(moved.values()) == len(payloads)


def test_decode_groups_packs_every_group():
    # three groups of 4 lanes, the last short, through the plain pack
    bs = 1024
    data = corpus.texty(10 * bs + 300, seed=6)
    payloads = native.blocks_compress(data, 1, 10, 10)
    sizes = [len(data[o:o + bs]) for o in range(0, len(data), bs)]
    st = {}
    out = sqz4_cuda.decode_groups(payloads, sizes, 10, device="cpu",
                                  lanes=4, stats=st)
    assert b"".join(out) == data
    assert {"upload_s", "pack_s", "kernel_s"} <= set(st)
