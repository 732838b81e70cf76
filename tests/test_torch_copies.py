"""The port's own copies of the reference's JAX-free modules give the
reference's results: the native runtime (a verbatim copy of the C++,
built by the port), the sqzt container framing and the input
generators."""

from pathlib import Path

import numpy as np
import pytest

from sqz_tpu import native as ref_native
from sqz_tpu.formats import container as ref_container
from sqz_tpu.utils import corpus as ref_corpus
from sqz_tpu_torch import native
from sqz_tpu_torch.formats import container
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
], ids=["plan_pack", "fast_plan", "tok_plan", "blocks_exact",
        "blocks_fast"])
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
