"""The port's own copies of the reference's JAX-free modules give the
reference's results: the native runtime (a verbatim copy of the C++,
built by the port), the sqzt container framing and the input
generators."""

from pathlib import Path

import numpy as np
import pytest

from sqz_tpu import native as ref_native
from sqz_tpu.formats import constants as ref_constants
from sqz_tpu.formats import container as ref_container
from sqz_tpu.utils import corpus as ref_corpus
from sqz_tpu_torch import native
from sqz_tpu_torch.formats import constants, container
from sqz_tpu_torch.utils import corpus

ROOT = Path(__file__).resolve().parents[1]

INPUTS = {
    "texty": ref_corpus.texty(9 * 1024 + 311, seed=5),
    "mixed": (ref_corpus.rle4(3000) + ref_corpus.zeros(2000)
              + ref_corpus.random_bytes(3000, seed=6)
              + ref_corpus.texty(4000, seed=7)),
}


def _equal(got, want):
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_native_source_is_the_references():
    assert ((ROOT / "sqz_tpu_torch" / "native" / "sqz_native.cpp")
            .read_bytes()
            == (ROOT / "sqz_tpu" / "native" / "sqz_native.cpp").read_bytes())


@pytest.mark.parametrize("kind", sorted(INPUTS))
@pytest.mark.parametrize("call", [
    lambda m, d: m.sqz4_plan_pack(d, 1 << 10, 10, True, 4, 2624),
    lambda m, d: m.sqz4_fast_plan(d, 1 << 10, 10, True, 2624),
    lambda m, d: m.sqz4_tok_plan(d, 1 << 10, 10, True, 96, 1024),
    lambda m, d: m.blocks_compress(d, 1, 10, 10),
    lambda m, d: m.blocks_compress(d, 1, 10, 10, parse="fast"),
    lambda m, d: m.squeeze_plan_pack(d, 10, 10, 4, 4160),
    lambda m, d: m.squeeze_plan_pack(d, 10, 10, 4, 4160, warm=True),
    lambda m, d: m.squeeze_plan_pack(d, 10, 10, 4, 4160, parse="fast"),
    lambda m, d: m.blocks_compress(d, 0, 10, 10),
    lambda m, d: m.blocks_compress(d, 0, 10, 10, warm=True),
    lambda m, d: m.blocks_compress(d, 0, 10, 10, warm=True, parse="fast"),
    lambda m, d: [m.squeeze_compress_payload(d[:1024], 10, parse=p)
                  for p in ("exact", "fast")],
], ids=["plan_pack", "fast_plan", "tok_plan", "blocks_exact",
        "blocks_fast", "squeeze_plan", "squeeze_plan_warm",
        "squeeze_plan_fast", "squeeze_blocks", "squeeze_blocks_warm",
        "squeeze_blocks_warm_fast", "squeeze_payload"])
def test_native_copy_equals_reference(call, kind):
    _equal(call(native, INPUTS[kind]), call(ref_native, INPUTS[kind]))


def test_native_host_codec_and_checksum_equal_reference():
    data = INPUTS["mixed"]
    payloads = native.blocks_compress(data, 1, 10, 10)
    assert native.blocks_decompress(payloads, len(data), 1, 10) == data
    assert native.sqz4_decompress_payload(payloads[2], 1024) == \
        data[2048:3072]
    assert native.fnv1a64(data) == ref_native.fnv1a64(data)
    np.testing.assert_array_equal(
        native.sqz4_pack_payloads(payloads, 4, 320),
        ref_native.sqz4_pack_payloads(payloads, 4, 320))


def test_squeeze_seeded_payloads_and_states_equal_reference():
    data = INPUTS["texty"]
    blk0, rest = data[:1024], data[1024:3072]
    pay, seed = native.squeeze_compress_payload(blk0, 10, return_state=True)
    rpay, rseed = ref_native.squeeze_compress_payload(blk0, 10,
                                                      return_state=True)
    assert pay == rpay
    assert seed.tolist() == list(rseed.lit) + list(rseed.pos)
    dec, dseed = native.squeeze_decompress_payload(pay, 1024,
                                                   return_state=True)
    assert dec == blk0 and dseed.tolist() == seed.tolist()
    for parse in ("exact", "fast"):
        w = native.squeeze_compress_payload(rest, 10, seed=seed,
                                            dictionary=blk0, parse=parse)
        assert w == ref_native.squeeze_compress_payload(
            rest, 10, seed=rseed, dictionary=blk0, parse=parse)
        assert native.squeeze_decompress_payload(
            w, len(rest), seed=seed, dictionary=blk0) == rest
    with pytest.raises(ValueError):
        native.squeeze_compress_payload(blk0, 10, seed=seed[:-1])


def test_model_stats_equal_reference():
    data = INPUTS["mixed"]
    mw, sw, _mx = native.sqz4_plan_pack(data, 1 << 10, 10, True, 4, 2624)
    m = mw[0, :, 1].astype(">u4").view(np.uint8)
    s = sw[0, :, 1].astype(">u4").view(np.uint8)
    _equal(native.sqz4_model_stats(m, s), ref_native.sqz4_model_stats(m, s))


@pytest.mark.parametrize("fmt", [0, 1])
def test_warm_blocks_decompress_equals_reference(fmt):
    data = INPUTS["texty"]
    payloads, fresh = ref_native.blocks_compress(data, fmt, 10, 10,
                                                 warm=True)
    assert not all(fresh)
    assert (native.blocks_decompress(payloads, len(data), fmt, 10,
                                     fresh_mask=fresh, win_bits=10)
            == data)
    with pytest.raises(ValueError):
        native.blocks_decompress(payloads, len(data), fmt, 10,
                                 fresh_mask=fresh[:-1], win_bits=10)


@pytest.mark.parametrize("kind", sorted(INPUTS) + ["tail", "tiny", "one"])
def test_warm_gate_copy_equals_reference(kind):
    if kind in INPUTS:
        parts = container.split_blocks(INPUTS[kind], 10)
    elif kind == "tail":
        parts = [INPUTS["texty"][:4096], ref_corpus.random_bytes(4096, 3),
                 INPUTS["texty"][:4096], b"abc"]
    elif kind == "tiny":
        parts = [b"ab", b"cd"]
    else:
        parts = [INPUTS["texty"]]
    for dictionary in (parts[0][-1024:], b"", parts[0][:3]):
        assert (constants.warm_gate_mask(parts, dictionary)
                == ref_constants.warm_gate_mask(parts, dictionary))
    for name in ("WARM_GATE_PROBE", "WARM_GATE_MIN_HITS",
                 "WARM_GATE_HASH_MUL", "WARM_GATE_BITS"):
        assert getattr(constants, name) == getattr(ref_constants, name)


@pytest.mark.parametrize("n,win_bits", [(0, 10), (3, 10), (1024, 10),
                                        (5000, 10), (40000, 15)])
def test_warm_dictionary_copy_equals_reference(n, win_bits):
    from sqz_tpu.api import _warm_dictionary
    block0 = ref_corpus.texty(n, seed=8)
    assert (constants.warm_dictionary(block0, win_bits)
            == _warm_dictionary(block0, win_bits))


def test_container_copy_equals_reference():
    data = INPUTS["texty"]
    payloads = native.blocks_compress(data, 1, 10, 10)
    csum = container.fnv1a64(data)
    blob = container.pack(1, 10, 10, len(data), payloads, csum)
    assert blob == ref_container.pack(1, 10, 10, len(data), payloads, csum)
    assert container.unpack(blob) == ref_container.unpack(blob)
    assert container.split_blocks(data, 10) == ref_container.split_blocks(
        data, 10)
    with pytest.raises(ValueError):
        container.unpack(blob[:-1])


@pytest.mark.parametrize("n,seed", [(0, 0), (1, 3), (4097, 1),
                                    (1 << 20, 9)])
def test_corpus_copy_equals_reference(n, seed):
    assert corpus.texty(n, seed) == ref_corpus.texty(n, seed)
    assert corpus.random_bytes(n, seed) == ref_corpus.random_bytes(n, seed)
    assert corpus.rle4(n) == ref_corpus.rle4(n)
    assert corpus.zeros(n) == ref_corpus.zeros(n)
    assert corpus.hello() == ref_corpus.hello()
