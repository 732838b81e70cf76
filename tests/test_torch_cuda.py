"""The CUDA kernels on a card: each equals its plain version, and the
slice round-trips through them, the pipeline included. Marked ``gpu``; skips without a CUDA
device. On a machine with one (and without JAX), run:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py
"""

import pytest
import torch

import sqz_tpu_torch

from sqz_tpu_torch import convert, native
from sqz_tpu_torch.formats import container
from sqz_tpu_torch.ops import engine, sqz4_cuda, sqz4_host as host, sqz4_ref
from sqz_tpu_torch.utils import corpus

pytestmark = pytest.mark.gpu

BLK, NB = 10, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_kernels_equal_plain_versions(cuda):
    bs = 1 << BLK
    data = corpus.texty(NB * bs, seed=3)
    mw, sw, mx = native.sqz4_plan_pack(data, 1 << 10, BLK, True, NB,
                                       host.op_stream_cap(BLK))
    m, s = convert.encoder_inputs(mw, sw, -(-int(mx) // 4), cuda)
    cw = host.cap_words_for(bs + 2048)
    before = sqz4_cuda.encode_full.launches
    got = sqz4_cuda.encode_full(m, s, cw)
    assert sqz4_cuda.encode_full.launches == before + 1
    want = sqz4_ref.encode_full_ref(m, s, cw)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    payloads = host.unpack_group_payloads(convert.to_numpy(got[0]),
                                          convert.to_numpy(got[1]), NB)
    plan = host.plan_decode_dispatch(NB, BLK, lanes=NB)
    buf, meta = host.pack_decode_chunk(payloads, [bs] * NB, NB, plan["G"],
                                       plan["Pw"])
    pt, mt = convert.decoder_inputs(buf, meta, cuda)
    args = (plan["t_max"], plan["lw"], plan["tw"], plan["mw"])
    got = sqz4_cuda.decode(pt, mt, *args)
    want = sqz4_ref.decode_ref(pt, mt, *args)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_token_and_compaction_kernels_equal_plain_versions(cuda):
    bs = 1 << BLK
    data = (corpus.texty(NB * bs, seed=4) + corpus.zeros(2 * bs)
            + corpus.random_bytes(2 * bs, seed=5))
    grp = sqz4_cuda.plan_tok_group(data, BLK, 1 << 10, True)
    toks = grp.toks.to(cuda).view(torch.uint32)
    lits = grp.lits.to(cuda)
    cw = host.cap_words_for(bs + 2048)
    before = sqz4_cuda.encode_tok.launches
    got = sqz4_cuda.encode_tok(toks, lits, grp.t_max, cw)
    assert sqz4_cuda.encode_tok.launches == before + 1
    want = sqz4_ref.encode_tok_ref(toks, lits, grp.t_max, cw)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    words, lens = got
    before = sqz4_cuda.compact_words.launches
    flat = sqz4_cuda.compact_words(words, lens, len(grp.fit) - 1)
    assert sqz4_cuda.compact_words.launches == before + 1
    assert torch.equal(flat.view(torch.int32), sqz4_ref.compact_ref(
        words, lens, len(grp.fit) - 1).view(torch.int32))


def test_slice_round_trips_on_the_card(cuda, monkeypatch):
    data = corpus.texty(20000, seed=6) + corpus.random_bytes(5000, seed=7)
    blob = sqz_tpu_torch.compress(data, parse="exact", blk_bits=12)
    assert container.unpack(blob)[4] == native.blocks_compress(data, 1, 15,
                                                               12)
    assert sqz_tpu_torch.decompress(blob) == data
    # more than one group (shrunk to 2 blocks): the pipeline's branch
    monkeypatch.setattr(engine, "LANES", 2)
    monkeypatch.setattr(host, "LANES", 2)
    fast = sqz_tpu_torch.compress(data, blk_bits=12)
    assert container.unpack(fast)[4] == sqz4_cuda.encode_data_full(
        data, 12, 1 << 15, True, 4096 + 2048, parse="fast")
    assert sqz_tpu_torch.decompress(fast) == data
