"""The CUDA kernels on a card: each equals its plain version (the seeded
and lit_skip modes too), and the slice round-trips through them, the
pipeline, warm start, anchored containers, the squeeze format and the
resident paths included. Marked
``gpu``; skips without a CUDA device. On a machine with
one (and without JAX), run:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import sqz_tpu_torch

from sqz_tpu_torch import convert, native
from sqz_tpu_torch.formats import container
from sqz_tpu_torch.ops import engine, sqz4_cuda, sqz4_host as host, sqz4_ref
from sqz_tpu_torch.ops import lzparse, probe, resident, squeeze_cuda
from sqz_tpu_torch.ops import squeeze_ref
from sqz_tpu_torch.utils import corpus, synthetic

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


def test_token_encoder_and_decoder_on_literal_heavy_blocks(cuda):
    # literal-heavy and match-heavy blocks, 13 of them (the token
    # encoder's last CTA of four blocks holds one): the token encoder
    # gives the plain version's payloads and the decoder restores them
    bs = 1 << BLK
    data = (corpus.random_bytes(6 * bs, seed=13)
            + corpus.texty(6 * bs + bs // 2, seed=14))
    grp = sqz4_cuda.plan_tok_group(data, BLK, 1 << 10, True)
    toks = grp.toks.to(cuda).view(torch.uint32)
    lits = grp.lits.to(cuda)
    cw = host.cap_words_for(bs + 2048)
    got = sqz4_cuda.encode_tok(toks, lits, grp.t_max, cw)
    want = sqz4_ref.encode_tok_ref(toks, lits, grp.t_max, cw)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    payloads = native.blocks_compress(data, 1, 10, BLK)
    sizes = [len(data[o:o + bs]) for o in range(0, len(data), bs)]
    assert b"".join(sqz4_cuda.decode_groups(payloads, sizes, BLK,
                                            device=cuda)) == data


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


def test_bitpacker_equals_plain_version(cuda):
    bs = 1 << BLK
    data = (corpus.texty(NB * bs, seed=8) + corpus.zeros(bs)
            + corpus.random_bytes(bs, seed=9))
    words, mx = native.squeeze_plan_pack(data, 10, BLK, NB,
                                         squeeze_cuda.record_cap(BLK))
    ops = squeeze_cuda.upload_rows(words, int(mx), cuda)
    cw = host.cap_words_for(bs + 4096)
    before = squeeze_cuda.bitpack.launches
    got = squeeze_cuda.bitpack(ops, cw)
    assert squeeze_cuda.bitpack.launches == before + 1
    want = squeeze_ref.bitpack_ref(ops, cw)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    nb = len(data) // bs
    assert (host.unpack_group_payloads(convert.to_numpy(got[0]),
                                       convert.to_numpy(got[1]), nb)
            == native.blocks_compress(data, 0, 10, BLK))


@pytest.mark.parametrize("tile_rows", [128, 256])
def test_bitpacker_tiles_equal_plain_version(cuda, monkeypatch, tile_rows):
    # three groups, a last lane group of 8, a last tile cut short; pads
    # mid-column, empty lanes, totals at multiples of 32 and 64, one lane
    # filling the capacity exactly and some past it
    monkeypatch.setattr(squeeze_cuda, "TILE_ROWS", tile_rows)
    rng = np.random.default_rng(tile_rows)
    G, T, B, cw = 3, 3 * 256 + 77, 72, 512
    nbs = rng.integers(1, 26, (G, T, B)).astype(np.uint32)
    nbs[rng.random(nbs.shape) < 0.25] = 0
    nbs[:, :, [0, 40, 71]] = 0
    nbs[:, :, 1:3] = 0
    nbs[:, :768, 1] = 16                   # 12288 bits: 64 x 192
    nbs[:, :772, 2] = 8                    # 6176 bits: 32 x 193
    nbs[:, :, 3] = 0
    nbs[:, :655, 3] = 25
    nbs[:, 700, 3] = 9                     # 16384 bits: the capacity
    nbs[:, :, 4] = 25                      # past it
    vals = rng.integers(0, 1 << 25, nbs.shape).astype(np.uint32)
    ops = convert.to_device((nbs << 25) | (vals & ((np.uint32(1) << nbs)
                                                   - np.uint32(1))), cuda)
    before = squeeze_cuda.bitpack.launches
    got = squeeze_cuda.bitpack(ops, cw)
    assert squeeze_cuda.bitpack.launches == before + 1
    want = squeeze_ref.bitpack_ref(ops, cw)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    lens = convert.to_numpy(got[1])[:, 0]
    assert (lens[:, 3] == 4 * cw).all() and (lens[:, 4] > 4 * cw).all()
    assert (lens[:, [0, 40, 71]] == 0).all()


@pytest.mark.parametrize("tile_rows", [64, 128])
def test_compaction_tiles_equal_plain_version(cuda, monkeypatch, tile_rows):
    # 80 lanes, 70 active (the rest garbage lengths); word counts of 0,
    # one word, tile multiples, the whole column and random
    monkeypatch.setattr(sqz4_cuda, "COMPACT_ROWS", tile_rows)
    rng = np.random.default_rng(tile_rows)
    B, R, nb = 80, 600, 70
    wc = rng.integers(0, R + 1, B)
    wc[:6] = (0, 1, tile_rows, 3 * tile_rows, R, R - 1)
    lens = np.zeros((1, 8, B), np.int32)
    lens[0, 0] = np.maximum(4 * wc - rng.integers(0, 4, B), 0)
    lens[0, 0, nb:] = 999999
    words = rng.integers(0, 1 << 32, (1, R, B), dtype=np.uint64).astype(
        np.uint32)
    wt, lt = convert.to_device(words, cuda), convert.to_device(lens, cuda)
    before = sqz4_cuda.compact_words.launches
    flat = sqz4_cuda.compact_words(wt, lt, nb)
    assert sqz4_cuda.compact_words.launches == before + 1
    assert torch.equal(flat.view(torch.int32), sqz4_ref.compact_ref(
        wt, lt, nb).view(torch.int32))


def test_stats_encoder_equals_plain_version(cuda):
    bs = 1 << BLK
    data = corpus.texty(NB * bs, seed=10)
    st = host.op_stream_stats(data, 1 << 10, BLK, lanes=NB)
    packed = [convert.to_device(a, cuda)
              for a in sqz4_cuda.pack_group_stats(st, NB)]
    cw = host.cap_words_for(bs + 2048)
    before = sqz4_cuda.encode_stats.launches
    got = sqz4_cuda.encode_stats(*packed, cw)
    assert sqz4_cuda.encode_stats.launches == before + 1
    want = sqz4_ref.encode_stats_ref(*packed, cw)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert (sqz4_cuda.encode_groups(*st, bs + 2048, device=cuda, lanes=NB)
            == native.blocks_compress(data, 1, 10, BLK))


@pytest.mark.parametrize("which", ["ops", "stats"])
def test_encoders_code_synthetic_streams_like_plain_versions(cuda, which):
    # every op code and symbol, flushes and pads anywhere (runs of
    # flushes past a buffer's room), 41 blocks of mixed lengths up to 3,000
    # ops (the four-blocks-a-CTA launch's last CTA holds one block), and
    # a capacity some of them overflow
    cw = 192
    if which == "ops":
        m, s = (convert.to_device(a, cuda)
                for a in synthetic.op_stream(41, 3000, seed=31))
        got = sqz4_cuda.encode_full(m, s, cw)
        want = sqz4_ref.encode_full_ref(m, s, cw)
    else:
        packed = [convert.to_device(a, cuda)
                  for a in synthetic.stats_stream(41, 3000, seed=32)]
        got = sqz4_cuda.encode_stats(*packed, cw)
        want = sqz4_ref.encode_stats_ref(*packed, cw)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert (convert.to_numpy(got[1])[0, 0] > 4 * cw).any()


def test_probes_equal_plain_versions(cuda):
    before = probe.probe.launches
    for name, (got, want) in probe.run_probes(cuda).items():
        assert (got == want).all(), name
        plain = probe.plain(name, *probe.probe_tensors(name, cuda))
        assert (convert.to_numpy(plain) == got).all(), name
    assert probe.probe.launches == before + len(probe.PROBES)


def test_squeeze_round_trips_on_the_card(cuda):
    data = corpus.texty(30000, seed=11) + corpus.random_bytes(3000, seed=12)
    for warm in (False, True):
        blob = sqz_tpu_torch.compress(data, fmt="squeeze", parse="exact",
                                      blk_bits=12, warm=warm)
        res = native.blocks_compress(data, 0, 15, 12, warm=warm)
        payloads, fresh = res if warm else (res, None)
        assert blob == container.pack(0, 15, 12, len(data), payloads,
                                      container.fnv1a64(data), warm=warm,
                                      fresh_mask=fresh)
        assert sqz_tpu_torch.decompress(blob) == data


@pytest.mark.parametrize("parse", ["exact", "fast"])
def test_seeded_kernels_equal_plain_versions(cuda, parse):
    # the warm device pass (blocks 1+ from block 0's state, block 0 cold),
    # then blocks 1+ through the seeded decoder, matching into block 0
    bs = 1 << BLK
    data = corpus.texty(NB * bs, seed=13)
    cap = host.op_stream_cap(BLK)
    if parse == "exact":
        mw, sw, mx, seed = native.sqz4_plan_pack(data, 1 << 10, BLK, True,
                                                 NB, cap, warm=True)
        m, s = convert.encoder_inputs(mw, sw, -(-int(mx) // 4), cuda)
    else:
        m8, s8, mx, seed = native.sqz4_fast_plan(data, 1 << 10, BLK, True,
                                                 cap, warm=True)
        m, s = (sqz4_cuda.pack_ops_words(x) for x in convert.fast_plan_inputs(
            m8, s8, NB, -(-int(mx) // 4), cuda))
    col = convert.to_device(host.seed_column(seed), cuda)
    cw = host.cap_words_for(bs + 2048 + bs // 4)
    before = sqz4_cuda.encode_full.seeded_launches
    got = sqz4_cuda.encode_full(m, s, cw, col, 0)
    assert sqz4_cuda.encode_full.seeded_launches == before + 1
    want = sqz4_ref.encode_full_ref(m, s, cw, col, 0)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    payloads = host.unpack_group_payloads(convert.to_numpy(got[0]),
                                          convert.to_numpy(got[1]), NB)
    assert payloads[1] == native.sqz4_compress_payload(
        data[bs:2 * bs], 1 << 10, seed=seed, dictionary=data[:bs],
        parse=parse)
    plan = host.plan_decode_dispatch(NB - 1, BLK, lanes=NB)
    buf, meta = host.pack_decode_chunk(payloads[1:], [bs] * (NB - 1), NB,
                                       plan["G"], plan["Pw"], bs)
    pt, mt = convert.decoder_inputs(buf, meta, cuda)
    args = (plan["t_max"], plan["lw"], plan["tw"], plan["mw"])
    before = sqz4_cuda.decode.seeded_launches
    got = sqz4_cuda.decode(pt, mt, *args, seed=col)
    assert sqz4_cuda.decode.seeded_launches == before + 1
    want = sqz4_ref.decode_ref(pt, mt, *args, seed=col)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    outs = host.postprocess_decode(
        *[convert.to_numpy(x) for x in got], payloads[1:], [bs] * (NB - 1),
        bs, seed=seed, dictionary=data[:bs])
    assert b"".join(outs) == data[bs:]


def test_warm_and_anchored_containers_round_trip_on_the_card(cuda):
    data = (corpus.texty(24000, seed=14) + corpus.random_bytes(6000, seed=15)
            + corpus.texty(8000, seed=16))
    kw = dict(blk_bits=12, win_bits=12, parse="exact")
    blob = sqz_tpu_torch.compress(data, warm=True, **kw)
    payloads, fresh = native.blocks_compress(data, 1, 12, 12, warm=True)
    assert blob == container.pack(1, 12, 12, len(data), payloads,
                                  container.fnv1a64(data), warm=True,
                                  fresh_mask=fresh)
    before = sqz4_cuda.decode.seeded_launches
    assert sqz_tpu_torch.decompress(blob) == data
    assert sqz4_cuda.decode.seeded_launches == before + 1
    for fmt in ("sqz4", "squeeze"):
        blob = sqz_tpu_torch.compress(data, fmt=fmt, warm="anchors", **kw)
        assert sqz_tpu_torch.decompress(blob) == data


@pytest.mark.parametrize("mode", ["rle", "lz"])
def test_lit_skip_kernel_equals_plain_version(cuda, mode):
    # the device parse's tokens over the raw blocks of 13 lanes (the last
    # CTA of four holds one), every cell kind and a partial block: the
    # kernel equals the plain version, and the cold kernel on the same
    # tokens with the literals compacted gives the same payloads
    bs = 1 << BLK
    data = synthetic.resident_mix(13, BLK, seed=17)
    blocks, lengths, nb = resident._prep_blocks(data, BLK, 13, cuda)
    if mode == "rle":
        toks, pairs = resident.rle_plan_device(
            blocks, lengths, resident.rle_group_args(BLK)["Tt"])
    else:
        toks, pairs, _d = lzparse.lz_plan_device(
            blocks, lengths, lzparse.lz_group_args(BLK)["Tt"])
    cw = host.cap_words_for(bs + 2048)
    t_max = int(pairs.max())
    before = sqz4_cuda.encode_tok.lit_skip_launches
    got = sqz4_cuda.encode_tok(toks, blocks[None], t_max, cw, lit_skip=True)
    assert sqz4_cuda.encode_tok.lit_skip_launches == before + 1
    want = sqz4_ref.encode_tok_ref(toks, blocks[None], t_max, cw,
                                   lit_skip=True)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    lits = sqz4_ref.skip_literal_rows(toks, blocks[None]).to(cuda)
    cold = sqz4_cuda.encode_tok(toks, lits, t_max, cw)
    for a, b in zip(got, cold):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    payloads = host.unpack_group_payloads(convert.to_numpy(got[0]),
                                          convert.to_numpy(got[1]), nb)
    for b, p in enumerate(payloads):
        assert native.sqz4_decompress_payload(
            p, len(data[b * bs:(b + 1) * bs])) == data[b * bs:(b + 1) * bs]


def test_resident_paths_round_trip_on_the_card(cuda):
    # a uint8 CUDA tensor in, the CPU plain versions' containers out, and
    # restored into a CUDA tensor by the route each container takes
    # (an LZ lane without matches is cell-parsed: under "auto" the cell
    # assembly restores it)
    data = synthetic.resident_mix(11, BLK, seed=18)
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(cuda)
    for mode, assembly, route in (("lit", "auto", "cell"),
                                  ("rle", "auto", "cell"),
                                  ("lz", "auto", None),
                                  ("lz", "general", "general")):
        blob = sqz_tpu_torch.compress_resident(x, blk_bits=BLK, mode=mode)
        assert blob == sqz_tpu_torch.compress_resident(
            data, blk_bits=BLK, mode=mode, device="cpu")
        assert sqz_tpu_torch.decompress(blob) == data
        before = dict(resident.route_lanes)
        out = sqz_tpu_torch.decompress_resident(blob, assembly=assembly)
        assert out.is_cuda and out.cpu().numpy().tobytes() == data
        moved = {k: resident.route_lanes[k] - before[k] for k in before}
        assert moved["host"] == 0 and sum(moved.values()) == 11
        assert moved["general"] > 0 if route is None else moved[route] == 11
    code, wb, bb, osize, payloads, csum, _f, _a = container.unpack(blob)
    p = bytearray(payloads[3])
    p[len(p) // 2] ^= 0xFF
    payloads[3] = bytes(p)
    with pytest.raises((ValueError, OSError)):
        sqz_tpu_torch.decompress_resident(
            container.pack(code, wb, bb, osize, payloads, csum))
