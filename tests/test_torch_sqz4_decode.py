"""The port's sqz4 decoder (plain PyTorch version, CPU) against the JAX
package's Pallas decoder in interpret mode, the native engine, and the
reference's numpy host glue.

Tolerance is zero throughout: records, counts and bytes must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqz_tpu import native
from sqz_tpu.ops import sqz4_pallas as sp
from sqz_tpu.utils import corpus
from sqz_tpu_torch import convert
from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host

# the plain versions step over small tensors: one intra-op thread each,
# so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

LANES, BLK = 128, 9   # the Pallas interpret-mode size
N_MUTANTS = 5


def _mixed(n_blocks: int, bs: int) -> bytes:
    parts = []
    for b in range(n_blocks):
        parts.append((corpus.texty(bs, seed=b), corpus.rle4(bs),
                      corpus.zeros(bs),
                      corpus.random_bytes(bs, seed=b))[b % 4])
    return b"".join(parts)


def _both(payloads, sizes, wide):
    """Decode one 128-lane group with the Pallas kernel (interpret mode,
    the fused grammar the main path runs) and with the port."""
    plan = host.plan_decode_dispatch(len(payloads), BLK, lanes=LANES)
    buf, meta = host.pack_decode_chunk(payloads, sizes, LANES, plan["G"],
                                       plan["Pw"])
    args = (plan["t_max"], plan["lw"], plan["tw"], plan["mw"])
    ref = [np.asarray(a) for a in sp._decode_pallas(
        jnp.asarray(buf), jnp.asarray(meta), *args, interpret=True,
        wide=wide, slots=1, fused=True)]
    pt, mt = convert.decoder_inputs(buf, meta, "cpu")
    got = [convert.to_numpy(a) for a in sqz4_cuda.decode(pt, mt, *args)]
    return ref, got


def _assert_records_equal(ref, got, lanes):
    (rlit, rtok, rmrec, rcnt), (lit, tok, mrec, cnt) = ref, got
    for a, b in zip(ref, got):
        assert a.shape == b.shape and a.dtype == b.dtype
    for row in (0, 1, 2, 3, 4, 6):
        np.testing.assert_array_equal(cnt[:, row], rcnt[:, row])
    for lane in lanes:
        nlit, ntok, nmatch = (int(cnt[0, r, lane]) for r in (1, 2, 3))
        for a, b, n in ((lit, rlit, (nlit + 3) // 4),
                        (tok, rtok, (ntok + 31) // 32),
                        (mrec, rmrec, nmatch)):
            np.testing.assert_array_equal(a[0, :n, lane], b[0, :n, lane])


@pytest.mark.parametrize("wide", [False, True])
def test_plain_decoder_matches_pallas(wide):
    bs = 1 << BLK
    data = _mixed(LANES, bs)
    payloads = native.blocks_compress(data, 1, 10, BLK)
    ref, got = _both(payloads, [bs] * LANES, wide)
    assert not got[3][:, 4].any()
    _assert_records_equal(ref, got, range(LANES))
    outs = host.postprocess_decode(*got, payloads, [bs] * LANES, bs)
    assert b"".join(outs) == data


def _mutants():
    """Five corrupt payloads (one byte flipped, seeded) and the valid
    payloads of the rest of the group."""
    bs = 1 << BLK
    rng = np.random.default_rng(2024)
    data = _mixed(LANES, bs)
    payloads = native.blocks_compress(data, 1, 10, BLK)
    for lane in range(N_MUTANTS):
        p = bytearray(payloads[4 * lane])          # texty blocks
        pos = int(rng.integers(8, len(p) - 8))
        p[pos] ^= int(rng.integers(1, 256))
        payloads[4 * lane] = bytes(p)
    return payloads, [bs] * LANES


def test_corrupt_mutants_flagged_like_pallas():
    payloads, sizes = _mutants()
    ref, got = _both(payloads, sizes, wide=False)
    err, rerr = got[3][0, 4], ref[3][0, 4]
    np.testing.assert_array_equal(err, rerr)
    mutant_lanes = [4 * k for k in range(N_MUTANTS)]
    assert set(np.nonzero(err)[0]) == set(mutant_lanes)
    _assert_records_equal(ref, got, [b for b in range(LANES)
                                     if b not in mutant_lanes])
    with pytest.raises(ValueError, match="corrupt sqz4 block"):
        sqz4_cuda.decode_groups(payloads[:8], sizes[:8], BLK, device="cpu",
                                lanes=8)


def test_decode_groups_restores_native_payloads():
    bs = 1024
    data = (corpus.texty(2 * bs, seed=21) + corpus.rle4(bs)
            + corpus.zeros(bs) + corpus.random_bytes(bs, seed=22)
            + corpus.texty(300, seed=23))
    payloads = native.blocks_compress(data, 1, 10, 10)
    sizes = [len(data[o:o + bs]) for o in range(0, len(data), bs)]
    stats = {}
    outs = sqz4_cuda.decode_groups(payloads, sizes, 10, device="cpu",
                                   lanes=4, stats=stats)
    assert b"".join(outs) == data
    assert set(stats) == {"pack_s", "upload_s", "kernel_s", "fetch_s",
                          "assemble_s"}


def test_decode_groups_names_the_original_block():
    bs = 1024
    data = corpus.texty(4 * bs, seed=31)
    payloads = native.blocks_compress(data, 1, 10, 10)
    p = bytearray(payloads[2])
    p[len(p) // 2] ^= 0xFF
    payloads[2] = bytes(p)
    with pytest.raises(ValueError, match=r"block\(s\) \[7\]|block 7"):
        sqz4_cuda.decode_groups(payloads, [bs] * 4, 10, device="cpu",
                                block_ids=[5, 6, 7, 8])


# ---- host glue: the port's numpy helpers equal the reference's


@pytest.mark.parametrize("blk_bits", [8, 10, 14, 15, 16])
def test_plan_decode_dispatch_matches_reference(blk_bits):
    want = sp.plan_decode_dispatch(600, blk_bits, lanes=512, slots=1)
    got = host.plan_decode_dispatch(600, blk_bits, lanes=512)
    for k in ("G", "Pw", "lw", "tw", "mw", "t_max"):
        assert got[k] == want[k], k


def test_pack_decode_chunk_matches_reference():
    payloads = native.blocks_compress(corpus.texty(5000, seed=3), 1, 10, 10)
    sizes = [1024] * 4 + [5000 - 4096]
    want = sp.pack_decode_chunk(payloads, sizes, 4, 2, 320)
    got = host.pack_decode_chunk(payloads, sizes, 4, 2, 320)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        host.pack_decode_chunk([b"x" * 100], [10], 4, 1, 8)


def test_unpack_and_assemble_match_reference():
    rng = np.random.default_rng(8)
    words = rng.integers(0, 1 << 32, (2, 16, 4), dtype=np.uint64).astype(
        np.uint32)
    lens = np.zeros((2, 8, 4), np.int32)
    lens[:, 0] = rng.integers(0, 64, (2, 4))
    assert (host.unpack_group_payloads(words, lens, 7)
            == sp.unpack_group_payloads(words, lens, 7))
    tok = np.array([0b0110], np.uint32)      # lit, match, match, lit
    mrec = np.array([(3 << 16) | 1, (2 << 16) | 2], np.uint32)
    args = (tok, b"ab", mrec, 4, 7)
    assert host.assemble_tokens_numpy(*args) == sp.assemble_tokens_numpy(
        *args) == b"aaaaaab"


@pytest.mark.parametrize("parse,env", [("auto", None), ("exact", None),
                                       ("auto", "exact"), ("exact", "fast")])
def test_parse_mode_matches_reference(monkeypatch, parse, env):
    if env is None:
        monkeypatch.delenv("SQZ_PARSE", raising=False)
    else:
        monkeypatch.setenv("SQZ_PARSE", env)
    assert host.parse_mode(parse) == sp.parse_mode(parse)


def test_overflow_lanes_decode_on_the_host():
    bs = 1024
    data = corpus.texty(2 * bs, seed=41)
    payloads = native.blocks_compress(data, 1, 10, 10)
    plan = host.plan_decode_dispatch(2, 10, lanes=2)
    buf, meta = host.pack_decode_chunk(payloads, [bs] * 2, 2, 1, plan["Pw"])
    pt, mt = convert.decoder_inputs(buf, meta, "cpu")
    lit, tok, mrec, counts = (convert.to_numpy(a) for a in sqz4_cuda.decode(
        pt, mt, plan["t_max"], plan["lw"], plan["tw"], plan["mw"]))
    counts[0, 6, 1] = 1                      # as if lane 1's records overflowed
    mrec[0, :, 1] = 0
    outs = host.postprocess_decode(lit, tok, mrec, counts, payloads,
                                   [bs] * 2, bs)
    assert b"".join(outs) == data
