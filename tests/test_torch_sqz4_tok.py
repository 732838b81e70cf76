"""The port's token encoder (both modes) and payload compaction (plain
PyTorch versions, CPU) against the JAX package's Pallas kernels in
interpret mode, and the token encoder against the port's op-stream
encoder.

Tolerance is zero throughout: payload bytes and lengths must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqz_tpu import native as ref_native
from sqz_tpu.ops import sqz4_pallas as sp
from sqz_tpu_torch import convert, native
from sqz_tpu_torch.ops import pipeline, sqz4_cuda, sqz4_host as host
from sqz_tpu_torch.ops import sqz4_ref
from sqz_tpu_torch.utils import corpus, synthetic

# the plain versions step over small tensors: one intra-op thread each,
# so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

LANES, BLK = 128, 9   # the Pallas interpret-mode size
BS = 1 << BLK
CAP = BS + 2048


def _mixed(n_blocks: int) -> bytes:
    """Text, zeros, incompressible and two-byte-period blocks in turn."""
    return b"".join(
        (corpus.texty(BS, seed=b), corpus.zeros(BS),
         corpus.random_bytes(BS, seed=b), b"ab" * (BS // 2))[b % 4]
        for b in range(n_blocks))


def _round_up(n: int, m: int) -> int:
    return max(96, -(-n // m) * m)


@pytest.mark.parametrize("lz", [True, False])
def test_plain_token_encoder_matches_pallas(lz):
    data = _mixed(LANES)
    tok_cap, lit_cap = host.tok_caps(BLK)
    toks, lits, counts, mx = native.sqz4_tok_plan(data, 1 << 10, BLK, lz,
                                                  tok_cap, lit_cap)
    assert (counts[:, 2] >= 0).all()
    # the Pallas launcher's layout: [1, rows, lanes], rows 32-aligned >= 96
    tt = _round_up(int(counts[:, 0].max()), 32)
    lw = _round_up((int(counts[:, 1].max()) + 3) // 4, 32)
    cap_words = host.cap_words_for(CAP)
    tarr = np.zeros((1, LANES, tt), np.uint32)
    larr = np.zeros((1, LANES, lw * 4), np.uint8)
    tarr[0, :, :min(tt, tok_cap)] = toks[:, :tt]
    larr[0] = lits[:, :lw * 4]
    ref_words, ref_lens = map(np.asarray, sp._encode_tok_pallas(
        sp._transpose_tok(jnp.asarray(tarr)),
        sp._pack_ops_words(jnp.asarray(larr)), int(mx), cap_words,
        interpret=True))
    words, lens = map(convert.to_numpy, sqz4_cuda.encode_tok(
        torch.from_numpy(tarr.view(np.int32)).view(torch.uint32),
        torch.from_numpy(larr), int(mx), cap_words))
    assert words.shape == ref_words.shape and words.dtype == np.uint32
    np.testing.assert_array_equal(lens[:, 0], ref_lens[:, 0])
    for lane in range(LANES):
        n = (int(lens[0, 0, lane]) + 3) // 4
        np.testing.assert_array_equal(words[0, :n, lane],
                                      ref_words[0, :n, lane])
    want = ref_native.blocks_compress(data, 1, 10, BLK, lz=lz, parse="fast")
    assert host.unpack_group_payloads(words, lens, LANES) == want


@pytest.mark.parametrize("cut", [0, 9, 300])
def test_plain_lit_skip_encoder_matches_pallas(cut):
    # the lit_skip mode: tokens over the raw blocks (2 KiB, 32 lanes: the
    # Pallas launcher's [1, rows, lanes] layouts, literals as big-endian
    # words); cut 0: the longest lane's pairs, 9: inside lane 0's first
    # wait, 300: mid-block
    toks, raw, pairs = synthetic.skip_tokens(32, 11, seed=8)
    t_max = int(pairs.max()) if cut == 0 else cut
    tt = _round_up(toks.shape[1], 32)
    tarr = np.zeros((1, 32, tt), np.uint32)
    tarr[0, :, :toks.shape[1]] = toks
    cap_words = host.cap_words_for((1 << 11) + 2048)
    ref_words, ref_lens = map(np.asarray, sp._encode_tok_pallas(
        sp._transpose_tok(jnp.asarray(tarr)),
        sp._pack_ops_words(jnp.asarray(raw[None])), t_max, cap_words,
        interpret=True, lit_skip=True))
    words, lens = map(convert.to_numpy, sqz4_cuda.encode_tok(
        torch.from_numpy(tarr.view(np.int32)).view(torch.uint32),
        torch.from_numpy(raw[None]), t_max, cap_words, lit_skip=True))
    np.testing.assert_array_equal(lens[:, 0], ref_lens[:, 0])
    for lane in range(32):
        n = (int(lens[0, 0, lane]) + 3) // 4
        np.testing.assert_array_equal(words[0, :n, lane],
                                      ref_words[0, :n, lane])


INPUTS = {
    "texty": lambda n: corpus.texty(n, seed=11),
    "rle4": corpus.rle4,
    "zeros": corpus.zeros,
    "random": lambda n: corpus.random_bytes(n, seed=12),
    "mixed": lambda n: _mixed(-(-n // BS))[:n],
}


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_token_encoder_equals_op_stream_encoder(kind):
    data = INPUTS[kind](9 * BS + 123)
    want = sqz4_cuda.encode_data_full(data, BLK, 1 << 10, True, CAP,
                                      parse="fast", device="cpu")
    assert pipeline.encode_data_pipelined(data, BLK, 1 << 10, True, CAP,
                                          parse="fast", device="cpu") == want
    assert want == [ref_native.sqz4_compress_payload(
        data[o:o + BS], 1 << 10, parse="fast")
        for o in range(0, len(data), BS)]


def test_token_encoder_overflow_blocks_take_the_op_stream_kernel():
    data = _mixed(8)
    grp = sqz4_cuda.plan_tok_group(data, BLK, 1 << 10, True, tok_cap=64)
    assert grp.over and grp.fit
    got = pipeline.encode_data_pipelined(data, BLK, 1 << 10, True, CAP,
                                         parse="fast", device="cpu",
                                         tok_cap=64)
    assert got == sqz4_cuda.encode_data_full(data, BLK, 1 << 10, True, CAP,
                                             parse="fast", device="cpu")


def _compact_case(partial: bool):
    """The reference's cases (tests/test_sqz4_pallas.py:321-343): random
    lengths with a zero-length lane and a full column, and a partial group
    whose inactive lanes carry garbage lengths."""
    rng = np.random.default_rng(7)
    B, R = 16, 512
    blen = rng.integers(100, R * 4, B).astype(np.int32)
    blen[3] = 0
    blen[7] = R * 4
    lens = np.zeros((1, 8, B), np.int32)
    lens[0, 0] = blen
    words = rng.integers(0, 1 << 30, (1, R, B), dtype=np.uint32)
    nb = B
    if partial:
        lens[0, 0, 10:] = 999999
        nb = 10
    return words, lens, nb


@pytest.mark.parametrize("partial", [False, True])
def test_compaction_matches_pallas(partial):
    words, lens, nb = _compact_case(partial)
    want = sp.fetch_payloads_compact(jnp.asarray(words), lens, nb,
                                     interpret=True)
    wt, lt = convert.to_device(words, "cpu"), convert.to_device(lens, "cpu")
    assert sqz4_cuda.fetch_payloads(wt, lt, nb) == want
    np.testing.assert_array_equal(
        convert.to_numpy(sqz4_ref.compact_ref(wt, lt, nb)),
        np.concatenate([words[0, :(int(lens[0, 0, b]) + 3) // 4, b]
                        for b in range(nb)]))


def test_compaction_inputs_are_checked():
    words, lens, nb = _compact_case(False)
    wt, lt = convert.to_device(words, "cpu"), convert.to_device(lens, "cpu")
    with pytest.raises(ValueError):
        sqz4_cuda.compact_words(wt, lt, 17)
    with pytest.raises(ValueError):
        sqz4_cuda.compact_words(wt, lt[:, :4], nb)
    with pytest.raises(ValueError):
        sqz4_cuda.compact_words(wt.view(torch.int32), lt, nb)
    lens[0, 0, 2] = 4 * words.shape[1] + 1
    with pytest.raises(ValueError):
        sqz4_cuda.fetch_payloads(wt, convert.to_device(lens, "cpu"), nb)


def test_token_encoder_inputs_are_checked():
    toks = torch.zeros((1, 4, 8), dtype=torch.int32).view(torch.uint32)
    lits = torch.zeros((1, 4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        sqz4_cuda.encode_tok(toks.view(torch.int32), lits, 4, 32)
    with pytest.raises(ValueError):
        sqz4_cuda.encode_tok(toks, lits[:, :2], 4, 32)
    before = (sqz4_cuda.encode_tok.launches,
              sqz4_cuda.encode_tok.lit_skip_launches)
    for skip in (False, True):
        words, lens = sqz4_cuda.encode_tok(toks, lits, 4, 32, lit_skip=skip)
        assert int(lens.sum()) == 0 and words.shape == (1, 32, 4)
    assert (sqz4_cuda.encode_tok.launches,
            sqz4_cuda.encode_tok.lit_skip_launches) == before


@pytest.mark.parametrize("nb", [1, 600, 1500])
def test_tok_group_slab_matches_reference_sizing(nb):
    """The straggler sort and slab extents of pipeline.py:106-120, at the
    exact sizes the port uses (no jit buckets)."""
    rng = np.random.default_rng(nb)
    counts = rng.integers(1, 900, (nb, 3)).astype(np.int64)
    counts[rng.random(nb) < 0.1, 2] = -1
    fit, over, rows, lbytes, t_max = host.tok_group_slab(counts)
    ref_fit = sorted((b for b in range(nb) if counts[b, 2] >= 0),
                     key=lambda b: int(counts[b, 2]))
    assert fit == ref_fit
    assert over == [b for b in range(nb) if counts[b, 2] < 0]
    assert rows == int(counts[fit, 0].max())
    assert lbytes == int(counts[fit, 1].max())
    assert t_max == int(counts[fit, 2].max())
    assert host.tok_caps(16) == (min(-(-(2 * 65536 // 3 + 96) // 32) * 32,
                                     1 << 14), 65536)
