"""The port's stats-fed sqz4 encoder (plain PyTorch version, CPU) against
the JAX package's Pallas encoder in interpret mode, the oracle and the
native engine.

Tolerance is zero throughout: payload bytes must be equal."""

import numpy as np
import pytest
import torch

from sqz_tpu.formats.constants import PM_SYMS
from sqz_tpu.oracle.rangecoder import ProbModel
from sqz_tpu.oracle.sqz4 import sqz4_encode_payload
from sqz_tpu.ops import sqz4_jax
from sqz_tpu.ops import sqz4_pallas as sp
from sqz_tpu_torch import convert, native
from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host, sqz4_ref
from sqz_tpu_torch.utils import corpus

# the plain versions step over small tensors: one intra-op thread each,
# so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)


def _oracle_stats(data: bytes):
    """Literal-only op streams' statistics from the oracle's models, a
    flush as (0, 0, 1) (tests/test_sqz4_pallas.py's construction)."""
    ms, ss = sqz4_jax.microops_from_tokens([("lit", b) for b in data])
    start, size, total = np.zeros((3, len(ms)), np.uint32)
    pms = [ProbModel(int(n)) for n in PM_SYMS]
    for i, (m, s) in enumerate(zip(ms, ss)):
        if m == sqz4_jax.OP_FLUSH:
            start[i], size[i], total[i] = 0, 0, 1
        else:
            pm = pms[m]
            start[i], size[i], total[i] = (pm.start(int(s)),
                                           pm.freq[int(s)], pm.total())
            pm.update(int(s))
    return start, size, total


@pytest.mark.parametrize("seed,n", [(0, 40), (1, 97), (2, 200)])
def test_encode_groups_matches_pallas_and_oracle(seed, n):
    rng = np.random.default_rng(seed)
    # low-entropy bytes so the renormalization and underflow paths fire
    data = bytes(rng.integers(0, 4, size=n, dtype=np.uint8))
    start, size, total = _oracle_stats(data)
    got = sqz4_cuda.encode_groups(start[None], size[None], total[None],
                                  cap=2 * n + 64, device="cpu")
    want = sp.encode_groups(start[None], size[None], total[None],
                            cap=2 * n + 64, tc=64, interpret=True)
    assert got == want
    assert got[0] == sqz4_encode_payload(data, 1 << 15, lz=False)


def test_encode_groups_multi_block_equals_native():
    blk = 10
    data = (corpus.texty(5 * 1024, seed=1) + corpus.rle4(2048)
            + corpus.zeros(1024) + corpus.random_bytes(1024, seed=2)
            + corpus.texty(300, seed=3))
    start, size, total = host.op_stream_stats(data, 1 << 10, blk)
    got = sqz4_cuda.encode_groups(start, size, total, cap=1024 + 2048,
                                  device="cpu", lanes=4)
    assert got == native.blocks_compress(data, 1, 10, blk)
    # and as one launch of the Pallas encoder's 128-lane group
    want = sp.encode_groups(start, size, total, cap=1024 + 2048, tc=64,
                            interpret=True)
    assert got == want


def test_flush_reads_as_pad_without_the_total():
    """sqz4_model_stats gives (0, 0, 0) for a flush, which the encoder
    reads as a pad: the flush's byte is then missing."""
    data = corpus.texty(1024, seed=6)
    start, size, total = host.op_stream_stats(data, 1 << 10, 10)
    flushes = (start == 0) & (size == 0) & (total == 1)
    assert flushes.any()
    total0 = np.where(flushes, 0, total).astype(np.uint32)
    good = sqz4_cuda.encode_groups(start, size, total, 4096, device="cpu")
    bad = sqz4_cuda.encode_groups(start, size, total0, 4096, device="cpu")
    assert good == native.blocks_compress(data, 1, 10, 10)
    assert len(bad[0]) < len(good[0])


def test_totals_from_two_to_the_fifteen_raise_in_both_packages():
    start = np.zeros((1, 4), np.uint32)
    size = np.ones((1, 4), np.uint32)
    total = np.full((1, 4), 1 << 15, np.uint32)
    with pytest.raises(ValueError, match="2\\^15"):
        sqz4_cuda.encode_groups(start, size, total, cap=64, device="cpu")
    with pytest.raises(AssertionError):
        sp.encode_groups(start, size, total, cap=64, tc=64, interpret=True)
    total[0, 0] = (1 << 15) - 1          # the largest total both accept
    total[0, 1:] = 0
    assert (sqz4_cuda.encode_groups(start, size, total, cap=64,
                                    device="cpu")
            == sp.encode_groups(start, size, total, cap=64, tc=64,
                                interpret=True))


def test_stats_encoder_equals_op_stream_encoder_words():
    """The same block coded from its op streams (model-driven encoder)
    and from its statistics: the same words and lengths."""
    blk, lanes = 9, 4
    data = corpus.texty(4 * 512, seed=8)
    mw, sw, mx = native.sqz4_plan_pack(data, 1 << 10, blk, True, lanes,
                                       host.op_stream_cap(blk))
    rows = -(-int(mx) // 4)
    m, s = convert.encoder_inputs(mw, sw, rows, "cpu")
    cw = host.cap_words_for(512 + 2048)
    want = sqz4_ref.encode_full_ref(m, s, cw)
    st = host.op_stream_stats(data, 1 << 10, blk)
    got = sqz4_cuda.encode_stats(
        *sqz4_cuda.pack_group_stats(st, "cpu", lanes), cw)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
