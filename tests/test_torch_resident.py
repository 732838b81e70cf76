"""The port's resident paths (``sqz_tpu_torch/ops/resident.py``, the
plain versions on the CPU) against the JAX package's
(``sqz_tpu/ops/resident.py``, its Pallas kernels in interpret mode): the
cell parse's tokens and pair counts, the payloads of every mode, the
containers of ``compress_resident``, the cell restore's blocks and bad
flags, and ``decompress_resident`` under each assembly, from the same
numpy-seeded inputs. Tolerance is zero throughout: a lossless codec."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqz_tpu
import sqz_tpu_torch
from sqz_tpu import native
from sqz_tpu.formats import container as sqzt
from sqz_tpu.formats.constants import SQZT_FORMAT_SQZ4
from sqz_tpu.ops import resident as ref
from sqz_tpu.ops import sqz4_pallas as sp
from sqz_tpu.utils import corpus
from sqz_tpu_torch.ops import resident
from sqz_tpu_torch.utils import synthetic

# the plain versions step over small tensors: one intra-op thread each,
# so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

LANES = 32       # the reference's interpret-mode encoder lanes
DEC_LANES = 128  # and its decoder's
CPU = torch.device("cpu")


def _rle_cases():
    """tests/test_resident.py's cell-parse cases (1 KiB blocks)."""
    text = corpus.texty(1024, seed=5)
    return [
        bytes(1024), text, bytes(512) + text[:512],
        text[:256] + b"\xAA" * 512 + text[256:512], bytes(700),
        (b"x" * 127 + b"y") * 8, b"abcd" * 256, (text[:32] * 40)[:1024],
        b"ab" * 100 + b"abc" * 200 + b"\0" * 224,
        text[:384] + text[:128] + text[384:512] + text[:128]
        + text[512:768],
        text[:128] * 2 + text[128:256] + text[:128] + text[256:768],
        text[:128] + bytes(128) + text[128:256] + bytes(128)
        + text[128:256] + text[:100],
    ]


def _cells(seed, edits):
    """One 1 KiB block of eight random nonzero cells, with cells[i] =
    cells[j] (j an int) or zeros (j None) for each (i, j) of edits."""
    cells = np.random.default_rng(seed).integers(1, 256, (8, 128),
                                                 dtype=np.uint8)
    for i, j in edits:
        cells[i] = 0 if j is None else cells[j]
    return cells


def _blocks(parts, bs, lanes=LANES):
    """Blocks (bytes, at most bs each) -> ([lanes, bs] u8, [lanes] i32
    lengths), zero-padded."""
    arr = np.zeros((lanes, bs), np.uint8)
    lengths = np.zeros((lanes,), np.int32)
    for b, p in enumerate(parts):
        arr[b, :len(p)] = np.frombuffer(p, np.uint8)
        lengths[b] = len(p)
    return arr, lengths


def _cell_parse_both(parts, bs):
    arr, lengths = _blocks(parts, bs)
    Tt = ref.rle_group_args(bs.bit_length() - 1)["Tt"]
    want_t, want_p = map(np.asarray, ref._rle_tokens_from_blocks(
        jnp.asarray(arr), jnp.asarray(lengths), Tt))
    got_t, got_p = resident._rle_tokens_from_blocks(
        torch.from_numpy(arr), torch.from_numpy(lengths), Tt)
    return (got_t.numpy(), got_p.numpy()), (want_t[0].T, want_p)


def test_cell_parse_tokens_and_pairs_equal_the_reference():
    # every cell-parse case, the crafted far-copy and dedup blocks, the
    # mix of every cell kind, and lanes of no, one and tail-cell bytes
    parts = _rle_cases() + [
        _cells(2, [(2, None), (5, None)]).tobytes(),
        _cells(6, [(4, 0), (6, 0), (7, 2)]).tobytes(),
        _cells(7, [(1, 0), (3, 1)]).tobytes(),
    ]
    mix = synthetic.resident_mix(10, 10, seed=3)
    parts += [mix[o:o + 1024] for o in range(0, len(mix), 1024)]
    parts += [b"", b"\x07", bytes(200), corpus.texty(1000, seed=8)]
    assert len(parts) <= LANES
    (got_t, got_p), (want_t, want_p) = _cell_parse_both(parts, 1024)
    np.testing.assert_array_equal(got_t, want_t.astype(np.int64))
    np.testing.assert_array_equal(got_p, want_p)


def test_cell_parse_emits_far_zero_and_dedup_tokens():
    # tests/test_resident.py:393 and :492: an isolated zero cell copies
    # the nearest earlier zero cell; a repeated nonzero cell copies the
    # earliest eligible occurrence
    (zt, _), _ = _cell_parse_both([_cells(2, [(2, None), (5, None)])
                                   .tobytes()], 1024)
    assert zt[0, 5] == 128 | (1 << 8) | (9 << 9) | (384 << 16)
    (dt, _), _ = _cell_parse_both([_cells(6, [(4, 0), (6, 0), (7, 2)])
                                   .tobytes()], 1024)
    assert dt[0, 4] == 128 | (1 << 8) | (10 << 9) | (512 << 16)
    assert dt[0, 6] == 128 | (1 << 8) | (10 << 9) | (768 << 16)
    assert dt[0, 7] == 128 | (1 << 8) | (10 << 9) | (640 << 16)


def test_literal_tokens_equal_the_reference():
    lengths = np.array([0, 1, 254, 255, 256, 510, 511, 1024], np.int32)
    want = np.asarray(ref._tokens_from_lengths(jnp.asarray(lengths), 96))
    got = resident._tokens_from_lengths(torch.from_numpy(lengths), 96)
    np.testing.assert_array_equal(got.numpy(), want[0].T.astype(np.int64))


def _mixed_input():
    return (b"".join(_rle_cases()) + synthetic.resident_mix(6, 10, seed=4)
            + corpus.texty(1500, seed=9))


@pytest.mark.parametrize("mode", ["lit", "rle", "lz"])
def test_payloads_equal_the_reference(mode):
    data = _mixed_input()
    want = ref.encode_resident_blocks(data, 10, mode, lanes=LANES,
                                      interpret=True)
    # the port takes any lane count: 20 blocks a group, not a vreg
    # multiple, and the reference's payloads all the same
    got = resident.encode_resident_blocks(data, 10, mode, lanes=20,
                                          device=CPU)
    assert got == want
    parts = sqzt.split_blocks(data, 10)
    for p, blk in zip(got, parts):
        assert native.sqz4_decompress_payload(p, len(blk)) == blk


@pytest.mark.parametrize("mode", ["lit", "rle", "lz"])
def test_edge_inputs_equal_the_reference(mode):
    # empty, one byte, a partial tail cell, a partial block, at blk_bits 8
    for data in (b"", b"Z", bytes(300), corpus.texty(700, seed=2)):
        want = ref.encode_resident_blocks(data, 8, mode, lanes=LANES,
                                          interpret=True)
        assert resident.encode_resident_blocks(
            data, 8, mode, lanes=LANES, device=CPU) == want, data[:8]


@pytest.mark.parametrize("mode", ["rle", "lz"])
def test_containers_equal_the_reference(mode):
    # bytes and a tensor in, with the checksum; the container decodes on
    # the reference's engines
    data = bytes(512) + corpus.texty(700, seed=9) + b"ab" * 200
    want = sqz_tpu.compress_resident(data, blk_bits=9, mode=mode,
                                     checksum=True, interpret=True,
                                     lanes=LANES)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    for src in (data, x):
        assert sqz_tpu_torch.compress_resident(
            src, blk_bits=9, mode=mode, checksum=True, lanes=LANES,
            device="cpu") == want
    assert sqz_tpu.decompress(want, engine="native") == data


def test_small_blocks_take_the_literal_mode():
    # blocks below a cell (rle) or a parse segment (lz) code literal-only,
    # as the reference does
    data = corpus.texty(900, seed=1)
    for blk, mode in ((6, "rle"), (7, "lz")):
        assert resident.encode_resident_blocks(
            data, blk, mode, lanes=LANES, device=CPU) == \
            ref.encode_resident_blocks(data, blk, "lit", lanes=LANES,
                                       interpret=True)


def _lit_skip_payload(cells, kinds):
    """tests/test_resident.py:438: one hand-made cell-parsed block coded
    by the reference's lit_skip kernel (kinds[i] None: a literal cell,
    else a far-copy dist)."""
    bs = cells.size
    blocks = np.zeros((LANES, bs), np.uint8)
    blocks[0] = cells.reshape(-1)
    toks = np.zeros((1, 96, LANES), np.uint32)
    row = [128 if k is None else 128 | (1 << 8)
           | (int(k).bit_length() << 9) | (k << 16) for k in kinds]
    toks[0, :len(row) + 1, 0] = row + [0x1FF]
    words, lens = sp._encode_tok_pallas(
        jnp.asarray(toks), ref._pack_literal_words(jnp.asarray(blocks), 256),
        1024, ref.rle_group_args(10)["cap_words"], True, False,
        lit_skip=True)
    lens = np.asarray(lens)
    return sp.unpack_group_payloads(np.asarray(words), lens, 1)


def _restore_both(payloads, sizes, bs, general=False):
    """The cell (or general) restore of one group, reference and port:
    ((blocks, bad), (blocks, bad)) as numpy."""
    from sqz_tpu.ops import lz_restore as ref_lz
    from sqz_tpu_torch.ops import lz_restore
    blk = bs.bit_length() - 1
    plan = sp.plan_decode_dispatch(DEC_LANES, blk, lanes=DEC_LANES,
                                   slots=1,
                                   interpret=True)
    buf, plens, szs, _o = ref.pack_payload_group(payloads, sizes,
                                                 plan["Pw"], DEC_LANES)
    dargs = dict(Pw=plan["Pw"], t_max=plan["t_max"], lw=plan["lw"],
                 tw=plan["tw"], mw=plan["mw"], bs=bs, interpret=True,
                 wide=False)
    fn = ref_lz.decode_lz_group if general else ref.decode_rle_group
    wb, _c, wbad = fn(jnp.asarray(buf), jnp.asarray(plens),
                      jnp.asarray(szs), **dargs)
    pbuf, pplens, pszs, _o = resident.pack_payload_group(
        payloads, sizes, plan["Pw"], DEC_LANES)
    args = (torch.from_numpy(pbuf.view(np.int32)).view(torch.uint32),
            torch.from_numpy(pplens), torch.from_numpy(pszs),
            resident.decoder_args(blk, DEC_LANES), bs)
    fn = lz_restore.decode_lz_group if general else resident.decode_rle_group
    gb, _c, gbad = fn(*args)
    return (gb.numpy(), gbad.numpy()), (np.asarray(wb), np.asarray(wbad))


def _assert_restores_equal(got, want, n):
    np.testing.assert_array_equal(got[1][:n], want[1][:n])
    for b in np.nonzero(~want[1][:n])[0]:
        np.testing.assert_array_equal(got[0][b], want[0][b])


@pytest.mark.parametrize("case", ["literal_source", "nonliteral_source"])
def test_cell_restore_of_crafted_far_copies(case):
    # tests/test_resident.py:466 and :481: a far copy of a literal cell
    # restores on the card; a far copy of a periodic (non-literal) cell
    # fails the source verify and is flagged bad
    if case == "literal_source":
        cells = _cells(4, [(3, 1)])
        kinds = [None, None, None, 256, None, None, None, None]
    else:
        cells = _cells(5, [(1, 0), (3, 1)])
        kinds = [None, 128, None, 256, None, None, None, None]
    data = cells.tobytes()
    payloads = _lit_skip_payload(cells, kinds)
    assert native.sqz4_decompress_payload(payloads[0], 1024) == data
    got, want = _restore_both(payloads, [1024], 1024)
    _assert_restores_equal(got, want, 1)
    assert bool(got[1][0]) == (case == "nonliteral_source")
    if case == "literal_source":
        assert got[0][0].tobytes() == data
    blob = sqzt.pack(SQZT_FORMAT_SQZ4, 15, 10, 1024, payloads, None)
    out = sqz_tpu_torch.decompress_resident(blob, lanes=DEC_LANES,
                                            device="cpu")
    assert out.numpy().tobytes() == data


def test_cell_restore_blocks_and_flags_equal_the_reference():
    # resident RLE payloads (cell-parsed) beside host-parsed ones (not:
    # flagged bad) and corrupt ones (flagged by the decoder)
    data = b"".join(_rle_cases()[:8])
    rle = ref.encode_resident_blocks(data, 10, "rle", lanes=LANES,
                                     interpret=True)
    text = corpus.texty(4 * 1024, seed=12)
    host = [native.sqz4_compress_payload(text[o:o + 1024], 1 << 15)
            for o in range(0, len(text), 1024)]
    bad = bytearray(rle[1])
    bad[len(bad) // 2] ^= 0x5A
    payloads = rle + host + [bytes(bad)]
    sizes = ([len(p) for p in sqzt.split_blocks(data, 10)] + [1024] * 4
             + [1024])
    got, want = _restore_both(payloads, sizes, 1024)
    _assert_restores_equal(got, want, len(payloads))
    assert not want[1][:len(rle)].any() and want[1][len(rle):].all()


@pytest.mark.parametrize("assembly", ["auto", "cell", "general"])
def test_decompress_resident_equals_the_reference(assembly):
    # a resident RLE container and a host-parsed one (not cell-parsed):
    # the same bytes as the reference's restore, in a tensor on the
    # device asked for, by the routes the assembly gives
    data = bytes(1024) + corpus.texty(2200, seed=33) + b"abcd" * 300
    blobs = [sqz_tpu.compress_resident(data, blk_bits=10, interpret=True,
                                       lanes=LANES),
             sqz_tpu.compress(data, fmt="sqz4", engine="native",
                              blocks=True, blk_bits=10, checksum=False)]
    for blob in blobs:
        want = np.asarray(ref.decompress_resident(
            blob, lanes=DEC_LANES, interpret=True, assembly=assembly))
        before = dict(resident.route_lanes)
        got = sqz_tpu_torch.decompress_resident(blob, lanes=DEC_LANES,
                                                assembly=assembly,
                                                device="cpu")
        assert got.dtype == torch.uint8 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy().tobytes() == data
        moved = {k: resident.route_lanes[k] - before[k] for k in before}
        assert sum(moved.values()) == len(sqzt.unpack(blob)[4])
    # the host-parsed container: cell rejects every lane
    assert moved["cell"] == 0
    assert moved["host" if assembly == "cell" else "general"] > 0


def test_restore_of_tiny_blocks_and_corrupt_payloads():
    # blk_bits < 7 decodes on the host (tests/test_resident.py:339); a
    # corrupt payload raises
    data = corpus.texty(500, seed=19)
    blob = sqz_tpu_torch.compress_resident(data, blk_bits=6, device="cpu")
    out = sqz_tpu_torch.decompress_resident(blob, device="cpu")
    assert out.numpy().tobytes() == data
    blob = sqz_tpu_torch.compress_resident(data, blk_bits=8, mode="rle",
                                           lanes=LANES, device="cpu")
    code, wb, bb, osize, payloads, csum, _f, _a = sqzt.unpack(blob)
    p = bytearray(payloads[1])
    p[len(p) // 2] ^= 0xA5
    payloads[1] = bytes(p)
    with pytest.raises((ValueError, OSError)):
        sqz_tpu_torch.decompress_resident(
            sqzt.pack(code, wb, bb, osize, payloads, csum), lanes=LANES,
            device="cpu")


def test_resident_requests_are_checked():
    data = corpus.texty(300, seed=1)
    for kw in (dict(blk_bits=17), dict(blk_bits=0), dict(mode="zip")):
        with pytest.raises(ValueError):
            sqz_tpu_torch.compress_resident(data, device="cpu", **kw)
    with pytest.raises(ValueError):
        sqz_tpu_torch.compress_resident(
            torch.zeros(10, dtype=torch.int32), device="cpu")
    blob = sqz_tpu_torch.compress_resident(data, blk_bits=8, mode="lit",
                                           lanes=LANES, device="cpu")
    with pytest.raises(ValueError):
        sqz_tpu_torch.decompress_resident(blob, assembly="bogus",
                                          device="cpu")
    warm = sqz_tpu.compress(corpus.texty(3000, seed=2), engine="native",
                            blocks=True, blk_bits=10, warm=True)
    with pytest.raises(ValueError):
        sqz_tpu_torch.decompress_resident(warm, device="cpu")
