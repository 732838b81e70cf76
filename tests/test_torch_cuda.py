"""The CUDA kernels on a card: each equals its plain version, and the
slice round-trips through them. Marked ``gpu``; skips without a CUDA
device. On a machine with one (and without JAX), run:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py
"""

import pytest
import torch

from sqz_tpu import native
from sqz_tpu.utils import corpus
from sqz_tpu_torch import convert
from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host, sqz4_ref

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


def test_slice_round_trips_on_the_card(cuda):
    import sqz_tpu
    import sqz_tpu_torch
    data = corpus.texty(20000, seed=6) + corpus.random_bytes(5000, seed=7)
    kw = dict(fmt="sqz4", engine="torch", blocks=True, blk_bits=12,
              device="cuda")
    blob = sqz_tpu_torch.compress(data, parse="exact", **kw)
    assert blob == sqz_tpu.compress(data, fmt="sqz4", engine="native",
                                    blocks=True, blk_bits=12)
    assert sqz_tpu_torch.decompress(blob, engine="torch",
                                    device="cuda") == data
