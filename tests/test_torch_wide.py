"""sqz4 above 64 KiB blocks (``blk_bits`` 17..40) on the torch engine: the
reference's scan route (exact tokens and per-op model statistics on the
host, the stats-fed encoder, the decoder cold and seeded), with the plain
PyTorch versions on the CPU, against the JAX package's scan route and the
native engine.

Tolerance is zero throughout: payloads, containers and restored bytes
must be equal byte for byte."""

import pytest
import torch

import sqz_tpu
import sqz_tpu_torch
from sqz_tpu.formats import container as sqzt
from sqz_tpu.utils import corpus
from sqz_tpu_torch import native
from sqz_tpu_torch.ops import engine, sqz4_cuda, sqz4_host as host

# the plain versions step over small tensors: one intra-op thread each,
# so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

WIN = 15


def _kw(blk_bits, **kw):
    return dict(fmt="sqz4", blocks=True, blk_bits=blk_bits, win_bits=WIN,
                **kw)


def _mixed_blocks(blk_bits: int) -> bytes:
    """Two blocks, cheap for the plain versions: runs then pseudo-text in
    the first, pseudo-text of the same generator in the second (a warm
    gate candidate)."""
    bs = 1 << blk_bits
    return (corpus.rle4(bs - 20_000) + corpus.texty(20_000, seed=5)
            + corpus.texty(20_000, seed=6))


@pytest.mark.parametrize("warm", [False, True])
def test_blk_bits_18_containers_equal_reference_engines(warm):
    data = _mixed_blocks(18)
    before = engine.wide_blocks
    got = sqz_tpu_torch.compress(data, warm=warm, device="cpu", **_kw(18))
    assert got == sqz_tpu.compress(data, engine="native", warm=warm,
                                   parse="exact", **_kw(18))
    assert got == sqz_tpu.compress(data, engine="tpu", warm=warm,
                                   parse="exact", **_kw(18))
    if warm:   # block 1 is coded seeded
        assert sqzt.unpack(got)[6] == [True, False]
    assert sqz_tpu_torch.decompress(got, device="cpu") == data
    assert engine.wide_blocks == before + 4


def test_decode_buffers_follow_the_largest_block(monkeypatch):
    # a 20 KiB container at blk_bits 40: one block, and every buffer of
    # the route sized from its 20,000 bytes, none from 2^40 (nor from the
    # reference scan route's out_cap = 1 << blk_bits)
    data = corpus.texty(20_000, seed=7)
    plans = []
    plan = host.plan_decode_dispatch

    def spy(*a, **k):
        plans.append(plan(*a, **k))
        return plans[-1]
    monkeypatch.setattr(host, "plan_decode_dispatch", spy)
    blob = sqz_tpu_torch.compress(data, parse="exact", device="cpu",
                                  **_kw(40))
    code, _w, blk_bits, osize, payloads, _c, _f, _a = sqzt.unpack(blob)
    assert (blk_bits, osize) == (40, len(data))
    assert payloads == [native.sqz4_compress_payload(data, 1 << WIN)]
    assert sqz_tpu_torch.decompress(blob, device="cpu") == data
    bs = len(data)
    assert plans and all(p == dict(
        lanes=32, G=1, Pw=-(-(bs + 4096) // 4 + 31) // 32 * 32,
        lw=bs // 4, tw=(-(-bs // 32) + 1 + 31) // 32 * 32, mw=bs // 4,
        t_max=9 * bs + 64) for p in plans)
    # without a largest block, the reference's plan
    assert host.plan_decode_dispatch(600, 16) == plan(600, 16, largest=1 << 16)
    assert host.op_stream_cap(40, bs) == host.op_stream_cap(16, bs)


def test_group_lanes_follow_the_block_count():
    assert [host.group_lanes(n) for n in (0, 1, 31, 32, 33, 256, 511, 9000)] \
        == [32, 32, 32, 32, 64, 256, 512, 512]


def test_blk_bits_17_without_a_card_raises(monkeypatch):
    # the default device is the card: without one the route above 64 KiB
    # raises as the 64 KiB route does, and no block reaches a host codec
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = corpus.texty(140_000, seed=1)
    before = engine.wide_blocks
    for warm in (False, True):
        with pytest.raises(RuntimeError, match="cuda"):
            sqz_tpu_torch.compress(data, blk_bits=17, warm=warm)
    blob = sqz_tpu.compress(data, engine="native", **_kw(17))
    with pytest.raises(RuntimeError, match="cuda"):
        sqz_tpu_torch.decompress(blob)
    assert engine.wide_blocks == before


@pytest.mark.parametrize("warm", [False, True])
def test_decompress_range_at_blk_bits_17(warm):
    # decompress_range (a host feature, as in the reference) on containers
    # the route above 64 KiB wrote, ranges inside a block, across the
    # boundary and in the warm block
    data = _mixed_blocks(17)
    blob = sqz_tpu_torch.compress(data, warm=warm, device="cpu", **_kw(17))
    bs = 1 << 17
    for start, length in ((0, 1), (1000, 5000), (bs - 300, 600),
                          (bs + 7, 19_000), (len(data) - 1, 1)):
        want = data[start:start + length]
        assert sqz_tpu_torch.decompress_range(blob, start, length) == want
        assert sqz_tpu.decompress_range(blob, start, length) == want
    with pytest.raises(ValueError, match="host feature"):
        sqz_tpu_torch.decompress_range(blob, 0, 1, engine="torch")


def test_block_limit_is_named():
    # the widest block the kernels take (csrc/sqz4_div.cuh kMaxBlockBits),
    # the JAX package's own: an unsigned 32-bit step budget, int32 counts
    assert sqz4_cuda.MAX_BLOCK_BITS == 28
    assert 1 << 31 < 9 * (1 << sqz4_cuda.MAX_BLOCK_BITS) + 64 < 1 << 32
    sqz4_cuda.check_block_bytes(1 << 28)
    with pytest.raises(ValueError, match='2\\^28.*engine="native"'):
        sqz4_cuda.check_block_bytes((1 << 28) + 1)
    # a wider block raises the limit on compress and on decompress before
    # any coding (such containers take engine="native")
    data = bytes(1 << 28) + b"x"
    with pytest.raises(ValueError, match="2\\^28"):
        sqz_tpu_torch.compress(data, device="cpu", **_kw(29))
    del data
    blob = sqzt.pack(1, WIN, 29, (1 << 28) + 1, [b"\0" * 16])
    with pytest.raises(ValueError, match="2\\^28"):
        sqz_tpu_torch.decompress(blob, device="cpu")
    with pytest.raises(ValueError, match="blk_bits <= 16"):
        sqz4_cuda.encode_data_full(b"x" * 10, 17, 1 << WIN, True, 4096,
                                   device="cpu")

