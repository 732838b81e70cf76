"""The port's squeeze path on the CPU (plain PyTorch bit-packer) against the
JAX package: the packer against the Pallas kernel in interpret mode, the
whole-buffer encode against the Pallas encode and the native payloads,
and compress / decompress against the reference's native engine, cold
and warm (sqzt v2), for both parses.

Tolerance is zero throughout: payload bytes, lengths and containers must
be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqz_tpu
import sqz_tpu_torch
from sqz_tpu import native as ref_native
from sqz_tpu.formats import container as ref_container
from sqz_tpu.ops import sqz4_pallas as sp
from sqz_tpu_torch import convert, native
from sqz_tpu_torch.formats.constants import warm_gate_mask
from sqz_tpu_torch.ops import sqz4_host as host, squeeze_cuda, squeeze_ref
from sqz_tpu_torch.utils import corpus

# the plain versions step over small tensors: one intra-op thread each,
# so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

LANES, TC = 128, 64   # the Pallas interpret-mode size
BLK, WIN = 10, 10
BS = 1 << BLK


def _mix(n_blocks: int) -> bytes:
    """Text, run-length, zero and incompressible blocks in turn, and a
    short tail."""
    return b"".join(
        (corpus.texty(BS, seed=b), corpus.rle4(BS), corpus.zeros(BS),
         corpus.random_bytes(BS, seed=b))[b % 4]
        for b in range(n_blocks)) + corpus.texty(BS // 3, seed=99)


def _pack_both(ops: np.ndarray, cap_words: int):
    """(port payloads and lens, Pallas payloads and lens) of records
    [G, T, LANES]."""
    nb = ops.shape[0] * ops.shape[2]
    w, lens = squeeze_ref.bitpack_ref(convert.to_device(ops, "cpu"),
                                      cap_words)
    w, lens = convert.to_numpy(w), convert.to_numpy(lens)
    rw, rlens = sp._bitpack_pallas(jnp.asarray(ops), cap_words, TC,
                                   interpret=True)
    rw, rlens = np.asarray(rw), np.asarray(rlens)
    return ((host.unpack_group_payloads(w, lens, nb), lens[:, 0]),
            (sp.unpack_group_payloads(rw, rlens, nb), rlens[:, 0]))


@pytest.mark.parametrize("kind", ["texty", "mix"])
def test_plain_packer_matches_pallas_on_planner_records(kind):
    data = (corpus.texty(6 * BS, seed=3) if kind == "texty"
            else _mix(6))
    tw_cap = -(-(4 * BS + 64) // TC) * TC
    words, mx = native.squeeze_plan_pack(data, WIN, BLK, LANES, tw_cap,
                                         parse="exact")
    rows = max(-(-int(mx) // TC) * TC, TC)
    ops = np.ascontiguousarray(words[:, :rows])
    cw = host.cap_words_for(BS + 4096)
    got, want = _pack_both(ops, cw)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    nb = -(-len(data) // BS)
    assert got[0][:nb] == [ref_native.squeeze_compress_payload(
        data[o:o + BS], WIN) for o in range(0, len(data), BS)]


def test_plain_packer_matches_pallas_on_synthetic_records():
    """Bit counts 1..25, pads between records, streams ending exactly on
    32- and 64-bit boundaries, and an empty lane."""
    rng = np.random.default_rng(5)
    T = 2 * TC
    ops = np.zeros((1, T, LANES), np.uint32)

    def record(nb):
        return (nb << 25) | int(rng.integers(0, 1 << nb))

    for lane in range(1, LANES):
        if lane == 1:                       # 32 bits exactly
            nbs = [8, 8, 16]
        elif lane == 2:                     # 64 bits exactly
            nbs = [25, 25, 14]
        elif lane == 3:                     # 96 bits: 32-bit boundary
            nbs = [24] * 4
        elif lane == 4:                     # 128 bits: 64-bit boundary
            nbs = [16] * 8
        elif lane == 5:                     # every bit count once
            nbs = list(range(1, 26))
        else:
            nbs = rng.integers(1, 26, int(rng.integers(0, T))).tolist()
        rows = sorted(rng.choice(T, len(nbs), replace=False).tolist()) \
            if lane > 5 else range(len(nbs))
        for r, nb in zip(rows, nbs):
            ops[0, r, lane] = record(int(nb))
    got, want = _pack_both(ops, 128)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0][0] == b""
    assert [len(got[0][b]) for b in range(1, 5)] == [8, 8, 16, 16]


@pytest.mark.parametrize("parse", ["exact", "fast"])
def test_squeeze_encode_data_matches_pallas_and_native(parse):
    data = _mix(5)
    cap = BS + 4096
    got = squeeze_cuda.squeeze_encode_data(data, BLK, WIN, cap, parse=parse,
                                           device="cpu")
    want = sp.squeeze_encode_data(data, BLK, WIN, cap=cap, tc=TC,
                                  interpret=True, parse=parse)
    assert got == want
    assert got == [ref_native.squeeze_compress_payload(
        data[o:o + BS], WIN, parse=parse) for o in range(0, len(data), BS)]


def test_squeeze_encode_counts_no_launch_on_the_cpu():
    before = squeeze_cuda.bitpack.launches
    squeeze_cuda.squeeze_encode_data(corpus.texty(BS, seed=1), BLK, WIN,
                                     BS + 4096, device="cpu")
    assert squeeze_cuda.bitpack.launches == before


def _few_candidates() -> bytes:
    """Block 0 of text, incompressible blocks (no warm-gate candidates),
    one more text block and a tail: at most a quarter are candidates."""
    return (corpus.texty(BS, seed=1)
            + b"".join(corpus.random_bytes(BS, seed=20 + b)
                       for b in range(8))
            + corpus.texty(BS, seed=1)[:BS] + corpus.texty(300, seed=2))


def _many_candidates() -> bytes:
    return corpus.texty(6 * BS + 200, seed=4)


@pytest.mark.parametrize("parse", ["exact", "fast"])
@pytest.mark.parametrize("warm,inputs", [
    (False, "mix"), (True, "few"), (True, "many")])
def test_container_equals_native_engine(parse, warm, inputs):
    data = {"mix": lambda: _mix(5), "few": _few_candidates,
            "many": _many_candidates}[inputs]()
    parts = [data[o:o + BS] for o in range(0, len(data), BS)]
    gate = warm_gate_mask(parts, parts[0][-(1 << WIN):])
    if inputs == "few":       # the host-threads branch of the engine
        assert 0 < sum(gate) <= len(parts) // 4
    elif inputs == "many":    # the device pass of the seeded blocks
        assert sum(gate) > len(parts) // 4
    kw = dict(fmt="squeeze", blocks=True, blk_bits=BLK, win_bits=WIN,
              warm=warm, parse=parse)
    got = sqz_tpu_torch.compress(data, engine="torch", device="cpu", **kw)
    assert got == sqz_tpu.compress(data, engine="native", **kw)
    if warm:
        assert not all(ref_container.unpack(got)[6])
    assert sqz_tpu_torch.decompress(got, device="cpu") == data
    assert sqz_tpu.decompress(got, engine="native") == data


def test_native_warm_container_decodes():
    data = _many_candidates()
    blob = sqz_tpu.compress(data, fmt="squeeze", engine="native",
                            blocks=True, blk_bits=BLK, win_bits=WIN,
                            warm=True)
    assert sqz_tpu_torch.decompress(blob, device="cpu") == data


def test_unported_squeeze_requests_raise_not_implemented():
    # the requests this test once saw refused (sqz4 warm start, anchored
    # warm start in both formats, anchored containers) are served: they
    # give the native engine's containers and bytes
    data = _many_candidates()
    kw = dict(blocks=True, blk_bits=BLK, win_bits=WIN, device="cpu")
    ref_kw = dict(blocks=True, blk_bits=BLK, win_bits=WIN, engine="native",
                  parse="exact")
    for fmt in ("squeeze", "sqz4"):
        got = sqz_tpu_torch.compress(data, fmt=fmt, warm="anchors",
                                     parse="exact", **kw)
        assert got == sqz_tpu.compress(data, fmt=fmt, warm="anchors",
                                       **ref_kw)
    got = sqz_tpu_torch.compress(data, fmt="sqz4", warm=True, parse="exact",
                                 **kw)
    assert got == sqz_tpu.compress(data, fmt="sqz4", warm=True, **ref_kw)
    # a forged anchored (sqzt v3) container: cold payloads marked warm,
    # anchored on block 1; the port decodes it as the native engine does
    parts = [data[o:o + BS] for o in range(0, len(data), BS)]
    n = len(parts)
    payloads = native.blocks_compress(data, 0, WIN, BLK)
    blob = ref_container.pack(
        0, WIN, BLK, len(data), payloads, None, warm=True,
        fresh_mask=[True, True] + [False] * (n - 2),
        anchor_mask=[False, False, True] + [False] * (n - 3))

    def outcome(fn):
        try:
            return fn()
        except (ValueError, OSError):
            return "rejected"
    assert (outcome(lambda: sqz_tpu_torch.decompress(blob, device="cpu"))
            == outcome(lambda: sqz_tpu.decompress(blob, engine="native")))
    # a single block is never warm: served cold, as the reference does
    one = sqz_tpu_torch.compress(data[:BS], fmt="squeeze", warm=True,
                                 parse="exact", **kw)
    assert one == sqz_tpu.compress(data[:BS], fmt="squeeze",
                                   engine="native", blocks=True,
                                   blk_bits=BLK, win_bits=WIN)
