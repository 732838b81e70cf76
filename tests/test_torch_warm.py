"""sqz4 warm start (sqzt v2, FORMAT.md §3.1) in the port: the seeded
modes of the op-stream encoder and the decoder (plain PyTorch versions on
the CPU) against the JAX package's seeded Pallas kernels in interpret mode
and the native seeded codec, then the slice, ``sqz_tpu_torch.compress`` /
``decompress`` with ``warm=True``, against the JAX package's engines.

Tolerance is zero throughout: payloads, records and containers must be
equal byte for byte."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqz_tpu
import sqz_tpu_torch
from sqz_tpu.formats import container as sqzt
from sqz_tpu.ops import sqz4_pallas as sp
from sqz_tpu.oracle.sqz4 import ModelSeed
from sqz_tpu.utils import corpus
from sqz_tpu_torch import convert, native as port_native
from sqz_tpu_torch.formats.constants import warm_dictionary, warm_gate_mask
from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host

# the plain versions step over small tensors: one intra-op thread each,
# so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

BLK, WIN = 10, 10
BS = 1 << BLK
CAP = BS + 2048
LANES, DEC_BLK = 128, 9   # the Pallas interpret-mode decoder's group


def _module_input() -> bytes:
    return (corpus.texty(2 * BS, seed=5) + corpus.rle4(BS // 2)
            + corpus.random_bytes(BS // 2, seed=6))


def _seed_of(block: bytes, window: int = 1 << WIN):
    """The warm state a decoder derives from ``block`` coded cold:
    u32[610]."""
    payload = port_native.sqz4_compress_payload(block, window)
    return port_native.sqz4_decompress_payload(payload, len(block),
                                               return_state=True)[1]


@pytest.mark.parametrize("parse", ["exact", "fast"])
def test_seeded_encode_equals_pallas_interpret(parse):
    data = _module_input()
    ref = sp.encode_data_full(data, BLK, 1 << WIN, True, CAP, lanes=128,
                              warm=True, interpret=True, parse=parse)
    got = sqz4_cuda.encode_data_full(data, BLK, 1 << WIN, True, CAP,
                                     parse=parse, device="cpu", lanes=8,
                                     warm=True)
    assert got == ref
    # block 0 cold, blocks 1+ from its final state against its tail
    assert got[0] == port_native.sqz4_compress_payload(data[:BS], 1 << WIN,
                                                       parse=parse)
    seed = _seed_of(data[:BS]) if parse == "exact" else \
        port_native.sqz4_decompress_payload(got[0], BS,
                                            return_state=True)[1]
    assert got[1] == port_native.sqz4_compress_payload(
        data[BS:2 * BS], 1 << WIN, seed=seed, dictionary=data[:BS],
        parse=parse)


def _seeded_group(corrupt: bool):
    """One decoder group of blocks coded warm from a foreign seed (16 KiB
    of pseudo-text: model totals at the rescale limit) against its tail:
    (payloads, sizes, seed, dictionary, parts)."""
    bs = 1 << DEC_BLK
    anchor = corpus.texty(1 << 14, seed=50)
    seed, dictionary = _seed_of(anchor), anchor[-(1 << WIN):]
    parts = [corpus.texty(bs, seed=51), corpus.rle4(bs),
             corpus.random_bytes(bs, seed=52), corpus.texty(bs - 77, seed=50)]
    payloads = [port_native.sqz4_compress_payload(
        p, 1 << WIN, seed=seed, dictionary=dictionary) for p in parts]
    if corrupt:
        rng = np.random.default_rng(53)
        for b in (0, 2):
            p = bytearray(payloads[b])
            p[int(rng.integers(0, len(p)))] ^= int(rng.integers(1, 256))
            payloads[b] = bytes(p)
    return payloads, [len(p) for p in parts], seed, dictionary, parts


def test_seeded_decoder_records_equal_pallas_interpret():
    payloads, sizes, seed, dictionary, _ = _seeded_group(corrupt=True)
    plan = host.plan_decode_dispatch(len(payloads), DEC_BLK, lanes=LANES)
    buf, meta = host.pack_decode_chunk(payloads, sizes, LANES, plan["G"],
                                       plan["Pw"], len(dictionary))
    args = (plan["t_max"], plan["lw"], plan["tw"], plan["mw"])
    tab = sp._dec_seed_table(ModelSeed(seed.tolist()), plan["G"], LANES)
    ref = [np.asarray(a) for a in sp._decode_pallas(
        jnp.asarray(buf), jnp.asarray(meta), *args, interpret=True,
        wide=True, slots=1, seed_tab=jnp.asarray(tab), fused=True)]
    pt, mt = convert.decoder_inputs(buf, meta, "cpu")
    col = convert.to_device(host.seed_column(seed), "cpu")
    got = [convert.to_numpy(a) for a in sqz4_cuda.decode(pt, mt, *args,
                                                         seed=col)]
    rlit, rtok, rmrec, rcnt = ref
    lit, tok, mrec, cnt = got
    for row in (0, 1, 2, 3, 4, 6):
        np.testing.assert_array_equal(cnt[:, row], rcnt[:, row])
    assert cnt[0, 4, 0] and cnt[0, 4, 2] and not cnt[0, 4, 1]
    for lane in range(len(payloads)):
        nlit, ntok, nmatch = (int(cnt[0, r, lane]) for r in (1, 2, 3))
        for a, b, n in ((lit, rlit, (nlit + 3) // 4),
                        (tok, rtok, (ntok + 31) // 32),
                        (mrec, rmrec, nmatch)):
            np.testing.assert_array_equal(a[0, :n, lane], b[0, :n, lane])


def test_seeded_decode_groups_equals_pallas_interpret():
    payloads, sizes, seed, dictionary, parts = _seeded_group(corrupt=False)
    ref = sp.decode_groups(payloads, sizes, DEC_BLK, interpret=True,
                           seed=ModelSeed(seed.tolist()),
                           dictionary=dictionary)
    got = sqz4_cuda.decode_groups(payloads, sizes, DEC_BLK, device="cpu",
                                  lanes=8, seed=seed, dictionary=dictionary)
    assert got == ref == parts


def test_plain_seeded_encoder_equals_native_seeded_codec():
    # every block warm (no fresh block) from a foreign seed: the blocks
    # equal the native seeded codec's, and the seed column is the
    # reference's encoder table column
    anchor = corpus.random_bytes(BS, seed=54) + corpus.texty(BS, seed=55)
    seed, dictionary = _seed_of(anchor), anchor[-(1 << WIN):]
    col = host.seed_column(seed)
    tab = sp._enc_seed_table(ModelSeed(seed.tolist()), 1, 128, False)
    np.testing.assert_array_equal(col, tab[0, :610, 0])
    parts = [corpus.texty(BS, seed=55), corpus.rle4(BS),
             corpus.zeros(BS // 2), corpus.random_bytes(BS // 3, seed=56)]
    lanes = len(parts)
    mw = np.full((1, host.op_stream_cap(BLK) // 4, lanes), 0xFFFFFFFF,
                 np.uint32)
    sw = np.zeros_like(mw)
    rows = 0
    for b, p in enumerate(parts):
        # one block a call: the planner tokenizes blocks 1+ of a warm
        # plan against block 0's tail, so the dictionary goes first
        m1, s1, mx, _ = port_native.sqz4_plan_pack(
            dictionary + p, 1 << WIN, BLK, True, 1, host.op_stream_cap(BLK),
            warm=True)
        mw[0, :, b], sw[0, :, b] = m1[1, :, 0], s1[1, :, 0]
        rows = max(rows, -(-int(mx) // 4))
    m, s = convert.encoder_inputs(mw, sw, rows, "cpu")
    words, lens = sqz4_cuda.encode_full(m, s, host.cap_words_for(CAP + BS),
                                        convert.to_device(col, "cpu"))
    got = host.unpack_group_payloads(convert.to_numpy(words),
                                     convert.to_numpy(lens), lanes)
    want = [port_native.sqz4_compress_payload(
        p, 1 << WIN, seed=seed, dictionary=dictionary) for p in parts]
    assert got == want


def test_seed_totals_keep_the_divider_exact():
    # a warm block's model totals: the seed's (at most 2^14 after the
    # rescale) plus one a coded symbol, at most bs + 1 in a block of bs
    # bytes; they stay below kTotalLimit (2^27 + 2^14 + 2 for the widest
    # block), inside the divider's exact range (csrc/sqz4_div.cuh)
    for block in (corpus.texty(1 << 16, seed=57),
                  corpus.random_bytes(1 << 16, seed=58), corpus.rle4(1 << 16),
                  corpus.zeros(1 << 16), _module_input()):
        f = _seed_of(block, 1 << 15).astype(np.int64)
        totals = ([f[0] + f[1], f[2:258].sum(), f[258:514].sum(),
                   f[514:546].sum()] + (f[546:578] + f[578:610]).tolist())
        assert max(totals) <= 1 << 14
        assert max(totals) + (1 << 16) < 1 << 17
        assert min(f) >= 1


# the warm gate's three branches (sqz_tpu/ops/engine.py:119-140): every
# block 1+ a candidate (the seeded device pass), one candidate in seven
# blocks (host threads), none (the cold payloads)
WARM_INPUTS = {
    "device": lambda: corpus.texty(6 * BS, seed=41),
    "host": lambda: (corpus.texty(BS, seed=42)
                     + corpus.random_bytes(5 * BS, seed=43)
                     + corpus.texty(700, seed=42)),
    "none": lambda: corpus.random_bytes(4 * BS, seed=44),
}


def _sqz4(engine, **kw):
    return dict(fmt="sqz4", engine=engine, blocks=True, blk_bits=BLK,
                win_bits=WIN, warm=True, **kw)


@pytest.mark.parametrize("kind", sorted(WARM_INPUTS))
def test_warm_container_equals_reference_engines(kind):
    data = WARM_INPUTS[kind]()
    parts = sqzt.split_blocks(data, BLK)
    n_cand = sum(warm_gate_mask(parts, warm_dictionary(parts[0], WIN)))
    assert {"device": n_cand > len(parts) // 4,
            "host": 0 < n_cand <= len(parts) // 4,
            "none": n_cand == 0}[kind]
    got = sqz_tpu_torch.compress(data, parse="exact", device="cpu",
                                 **_sqz4("torch"))
    assert got == sqz_tpu.compress(data, parse="exact", **_sqz4("native"))
    assert got == sqz_tpu.compress(data, parse="exact", **_sqz4("tpu"))
    fresh = sqzt.unpack(got)[6]
    assert (not all(fresh)) == (kind != "none")
    # the port decodes the reference's container (the same bytes), and
    # the reference the port's fast-parse one
    assert sqz_tpu_torch.decompress(got, device="cpu") == data
    fast = sqz_tpu_torch.compress(data, device="cpu", **_sqz4("torch"))
    assert sqz_tpu.decompress(fast, engine="native") == data


def test_port_decodes_reference_fast_warm_container():
    data = WARM_INPUTS["device"]()
    blob = sqz_tpu.compress(data, parse="fast", **_sqz4("native"))
    assert not all(sqzt.unpack(blob)[6])
    assert sqz_tpu_torch.decompress(blob, device="cpu") == data
