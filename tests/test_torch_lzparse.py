"""The port's device LZ matcher (``sqz_tpu_torch/ops/lzparse.py``, on the
CPU) against the JAX package's (``sqz_tpu/ops/lzparse.py``): the gram
tables, the best match per position, and the plan's tokens, pair counts
and demoted lanes, from the same numpy-seeded blocks; then its payloads
round-trip. Tolerance is zero throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqz_tpu
import sqz_tpu_torch
from sqz_tpu import native
from sqz_tpu.ops import lzparse as ref
from sqz_tpu.utils import corpus
from sqz_tpu_torch.ops import lzparse, resident
from sqz_tpu_torch.utils import synthetic

# the plain versions step over small tensors: one intra-op thread each,
# so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _mixed(n: int) -> bytes:
    """tests/test_lzparse.py's mix: text, zeros, a 4-byte period, random
    bytes."""
    text = corpus.texty(n, seed=5)
    rnd = np.random.default_rng(5).integers(0, 256, n // 4,
                                            dtype=np.uint8).tobytes()
    return (text[:n // 2] + b"\x00" * (n // 8) + b"abcd" * (n // 16)
            + rnd)[:n]


def _near_repeats() -> bytes:
    """tests/test_lzparse.py:118: period-4 runs with single-byte edits."""
    base = bytearray(b"abcd" * 256)
    for i in range(13, 1024, 97):
        base[i] ^= 0x55
    return bytes(base) * 2


def _blocks(bs: int = 1024):
    """[24, bs] u8 blocks of every kind and [24] lengths: full, partial,
    one byte and empty lanes."""
    data = (_mixed(8 * bs) + _near_repeats()[:2 * bs]
            + synthetic.resident_mix(10, bs.bit_length() - 1, seed=6))
    arr = np.zeros((24, bs), np.uint8)
    nb = min(24, -(-len(data) // bs))
    flat = np.frombuffer(data[:nb * bs], np.uint8)
    arr.reshape(-1)[:flat.size] = flat
    lengths = np.full((24,), bs, np.int32)
    lengths[nb - 1] = len(data[(nb - 1) * bs:nb * bs])
    lengths[nb:] = 0
    lengths[3], lengths[7] = 1, 700
    arr[3, 1:] = 0
    arr[7, 700:] = 0
    return arr, lengths


@pytest.mark.parametrize("k", ref.GRAM_SIZES)
def test_gram_tables_equal_the_reference(k):
    arr, lengths = _blocks()
    want = np.asarray(ref._table_dists(jnp.asarray(arr),
                                       jnp.asarray(lengths), k))
    got = lzparse._table_dists(torch.from_numpy(arr),
                               torch.from_numpy(lengths).long(), k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).any()


def test_best_matches_equal_the_reference():
    arr, lengths = _blocks()
    dists = [ref._table_dists(jnp.asarray(arr), jnp.asarray(lengths), k)
             for k in ref.GRAM_SIZES]
    want = [np.asarray(x) for x in ref._select_stage(jnp.asarray(lengths),
                                                     *dists)]
    ln = torch.from_numpy(lengths).long()
    got = lzparse._select_stage(ln, [torch.from_numpy(np.array(d))
                                     .long() for d in dists])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("Tt", [4, 96, 320])
def test_plan_equals_the_reference(Tt):
    # Tt 4 demotes lanes to the literal parse (tests/test_lzparse.py:47);
    # 320 is a 1 KiB group's own token budget
    arr, lengths = _blocks()
    toks, _lits, pairs, demote = map(np.asarray, ref.lz_plan_device(
        jnp.asarray(arr), jnp.asarray(lengths), Tt))
    got_t, got_p, got_d = lzparse.lz_plan_device(
        torch.from_numpy(arr), torch.from_numpy(lengths), Tt)
    np.testing.assert_array_equal(
        got_t.view(torch.int32).numpy().view(np.uint32), toks.transpose(
            0, 2, 1))
    np.testing.assert_array_equal(got_p.numpy(), pairs)
    np.testing.assert_array_equal(got_d.numpy(), demote)
    assert demote.any() if Tt == 4 else not demote.all()


def test_device_lz_round_trips_and_beats_literal_only():
    # the payloads of near repeats and of repetitive text decode on the
    # native engine (tests/test_lzparse.py:118, :35), and the LZ parse
    # codes the text in fewer bytes than literal-only
    for data in (_near_repeats(), (corpus.texty(2048, seed=1) * 3)[:4096]):
        lz = resident.encode_resident_blocks(data, 10, "lz", lanes=8,
                                             device=CPU)
        lit = resident.encode_resident_blocks(data, 10, "lit", lanes=8,
                                              device=CPU)
        parts = [data[o:o + 1024] for o in range(0, len(data), 1024)]
        for p, blk in zip(lz, parts):
            assert native.sqz4_decompress_payload(p, len(blk)) == blk
        assert sum(map(len, lz)) < 0.9 * sum(map(len, lit))


def test_lz_container_decodes_on_every_reference_engine():
    data = _mixed(6 * 512 + 123)   # a tail block shorter than the rest
    blob = sqz_tpu_torch.compress_resident(data, blk_bits=9, mode="lz",
                                           lanes=32, device="cpu")
    assert sqz_tpu.decompress(blob, engine="native") == data
    assert sqz_tpu.decompress(blob, engine="oracle") == data
