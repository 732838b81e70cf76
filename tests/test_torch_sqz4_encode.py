"""The port's sqz4 encoder (plain PyTorch version, CPU) against the JAX
package's Pallas encoder in interpret mode and against the native engine.

Tolerance is zero throughout: payload bytes and lengths must be equal."""

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

LANES, BLK, TC = 128, 9, 64   # the Pallas interpret-mode size


def _mixed(n_blocks: int, bs: int) -> bytes:
    """Text, RLE, zeros and incompressible blocks in turn."""
    parts = []
    for b in range(n_blocks):
        kind = b % 4
        if kind == 0:
            parts.append(corpus.texty(bs, seed=b))
        elif kind == 1:
            parts.append(corpus.rle4(bs))
        elif kind == 2:
            parts.append(corpus.zeros(bs))
        else:
            parts.append(corpus.random_bytes(bs, seed=b))
    return b"".join(parts)


@pytest.mark.parametrize("wide,fused", [(False, False), (True, True)])
def test_plain_encoder_matches_pallas(wide, fused):
    bs = 1 << BLK
    data = _mixed(LANES, bs)
    tp_cap = -(-(5 * bs // 2 + 64) // (4 * TC)) * 4 * TC
    mw, sw, mx = native.sqz4_plan_pack(data, 1 << 10, BLK, True, LANES,
                                       tp_cap, paired=fused)
    rows = -(-int(mx) // (4 * TC)) * TC
    cap_words = host.cap_words_for(bs + 2048)
    ref_words, ref_lens = map(np.asarray, sp._encode_full_pallas(
        jnp.asarray(mw[:, :rows]), jnp.asarray(sw[:, :rows]), cap_words, TC,
        interpret=True, wide=wide, fused=fused))
    m, s = convert.encoder_inputs(mw, sw, rows, "cpu")
    words, lens = map(convert.to_numpy, sqz4_cuda.encode_full(m, s,
                                                              cap_words))
    assert words.shape == ref_words.shape and words.dtype == np.uint32
    np.testing.assert_array_equal(lens[:, 0], ref_lens[:, 0])
    for lane in range(LANES):
        n = (int(lens[0, 0, lane]) + 3) // 4
        np.testing.assert_array_equal(words[0, :n, lane],
                                      ref_words[0, :n, lane])
    assert (host.unpack_group_payloads(words, lens, LANES)
            == native.blocks_compress(data, 1, 10, BLK))


INPUTS = {
    "texty": lambda n: corpus.texty(n, seed=11),
    "rle4": corpus.rle4,
    "zeros": corpus.zeros,
    "random": lambda n: corpus.random_bytes(n, seed=12),
}


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_encode_data_full_exact_equals_native(kind):
    data = INPUTS[kind](3 * 1024 + 517)
    got = sqz4_cuda.encode_data_full(data, 10, 1 << 10, True, 1024 + 2048,
                                     parse="exact", device="cpu")
    assert got == native.blocks_compress(data, 1, 10, 10)


def test_encode_data_full_literal_only_equals_native():
    data = corpus.texty(2 * 1024, seed=13)
    got = sqz4_cuda.encode_data_full(data, 10, 1 << 10, False, 1024 + 2048,
                                     parse="exact", device="cpu")
    assert got == native.blocks_compress(data, 1, 10, 10, lz=False)


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_encode_data_full_fast_restores(kind):
    bs = 1024
    data = INPUTS[kind](3 * bs + 100)
    got = sqz4_cuda.encode_data_full(data, 10, 1 << 10, True, bs + 2048,
                                     parse="fast", device="cpu")
    parts = [data[o:o + bs] for o in range(0, len(data), bs)]
    assert len(got) == len(parts)
    for payload, part in zip(got, parts):
        assert native.sqz4_decompress_payload(payload, len(part)) == part
        assert payload == native.sqz4_compress_payload(part, 1 << 10,
                                                       parse="fast")


def test_pack_ops_words_matches_reference_relayout():
    rng = np.random.default_rng(5)
    x8 = rng.integers(0, 256, size=(2, 8, 24), dtype=np.uint8)
    want = np.asarray(sp._pack_ops_words(jnp.asarray(x8)))
    got = convert.to_numpy(sqz4_cuda.pack_ops_words(torch.from_numpy(x8)))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = sqz4_cuda.encode_full.launches
    m = convert.to_device(np.full((1, 4, 2), 0xFFFFFFFF, np.uint32), "cpu")
    s = convert.to_device(np.zeros((1, 4, 2), np.uint32), "cpu")
    words, lens = sqz4_cuda.encode_full(m, s, 32)
    assert sqz4_cuda.encode_full.launches == before
    assert int(lens.sum()) == 0 and words.shape == (1, 32, 2)


def test_kernel_inputs_are_checked():
    m = convert.to_device(np.zeros((1, 4, 2), np.uint32), "cpu")
    with pytest.raises(ValueError):
        sqz4_cuda.encode_full(m.view(torch.int32), m.view(torch.int32), 32)
    with pytest.raises(ValueError):
        sqz4_cuda.encode_full(m, m[:, :2], 32)
    meta_m = torch.zeros((1, 4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        sqz4_cuda.encode_full(meta_m.view(torch.uint32),
                              meta_m.view(torch.uint32), 32)


def test_blk_bits_above_16_rejected():
    with pytest.raises(ValueError):
        sqz4_cuda.encode_data_full(b"x" * 10, 17, 1 << 10, True, 4096,
                                   device="cpu")
