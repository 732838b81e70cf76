"""Anchored warm start (sqzt v3, FORMAT.md §3.2) in both formats, corrupt
warm containers, and sqz4 at ``blk_bits`` above 16 (the route above
64 KiB blocks) in the port, against the JAX package's engines (plain
PyTorch versions on the CPU for the kernels).

Tolerance is zero throughout: containers and restored bytes must be
equal byte for byte."""

import numpy as np
import pytest
import torch

import sqz_tpu
import sqz_tpu_torch
from sqz_tpu.formats import container as sqzt
from sqz_tpu.utils import corpus
from sqz_tpu_torch.formats import anchors as port_anchors
from sqz_tpu_torch.formats import container as port_container
from sqz_tpu_torch.ops import engine

# the plain versions step over small tensors: one intra-op thread each,
# so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

BLK, WIN = 10, 10
BS = 1 << BLK
WIDE_BYTES = (1 << 17) + (1 << 14)   # two blocks at blk_bits 17


def _anchored_input() -> bytes:
    """Seven blocks whose v3 plan anchors two warm blocks on block 3 (the
    nearest fresh block) and two on block 0: pseudo-text, random bytes,
    runs, pseudo-text again."""
    return (corpus.texty(2 * BS, seed=1) + corpus.random_bytes(BS, seed=2)
            + corpus.rle4(3 * BS) + corpus.texty(BS, seed=3))


def _kw(fmt, engine, **kw):
    return dict(fmt=fmt, engine=engine, blocks=True, blk_bits=BLK,
                win_bits=WIN, warm="anchors", **kw)


@pytest.mark.parametrize("fmt", ["sqz4", "squeeze"])
def test_anchored_container_equals_reference_engines(fmt):
    data = _anchored_input()
    got = sqz_tpu_torch.compress(data, parse="exact", device="cpu",
                                 **_kw(fmt, "torch"))
    assert got == sqz_tpu.compress(data, parse="exact", **_kw(fmt, "native"))
    assert got == sqz_tpu.compress(data, parse="exact", **_kw(fmt, "tpu"))
    fresh, anch = sqzt.unpack(got)[6:]
    anchors = port_container.resolve_anchors(fresh, anch)
    assert {a for a in anchors if a is not None} == {0, 3}
    # each package decodes the other's containers
    assert sqz_tpu_torch.decompress(got, device="cpu") == data
    fast = sqz_tpu_torch.compress(data, device="cpu", **_kw(fmt, "torch"))
    assert fast == sqz_tpu.compress(data, **_kw(fmt, "tpu"))
    assert sqz_tpu.decompress(fast, engine="native") == data
    ref = sqz_tpu.compress(data, parse="fast", **_kw(fmt, "native"))
    assert sqz_tpu_torch.decompress(ref, device="cpu") == data


def test_anchored_plan_copy_equals_reference_plan():
    # the port's copy of the planner, with the port's per-block encoder,
    # against the reference's on every beam width the API takes
    from sqz_tpu import api as ref_api
    from sqz_tpu_torch import api
    data = _anchored_input()
    parts = sqzt.split_blocks(data, BLK)
    for beam in (1, 2, 4):
        for fmt in ("sqz4", "squeeze"):
            want = ref_api._compress_anchored(
                parts, ref_api.Format(fmt), ref_api.Engine.NATIVE, WIN, True,
                beam, "exact")
            got = api._compress_anchored(parts, api.Format(fmt), WIN, True,
                                         beam, "exact")
            assert got == want
    with pytest.raises(ValueError):
        port_anchors.plan_anchored(parts, None, None, beam=0)


def test_corrupt_warm_block0_rejected():
    # block 0's decode seeds the warm blocks: a corrupt block 0 must raise,
    # never give other bytes
    data = corpus.texty(6 * BS, seed=4)
    blob = sqz_tpu_torch.compress(data, warm=True, parse="exact",
                                  device="cpu", fmt="sqz4", blk_bits=BLK,
                                  win_bits=WIN)
    code, win_bits, blk_bits, osize, payloads, csum, fresh, _ = \
        sqzt.unpack(blob)
    assert not all(fresh)
    p = bytearray(payloads[0])
    p[len(p) // 2] ^= 0x10
    payloads[0] = bytes(p)
    bad = sqzt.pack(code, win_bits, blk_bits, osize, payloads, csum,
                    warm=True, fresh_mask=fresh)
    with pytest.raises((ValueError, OSError)):
        sqz_tpu_torch.decompress(bad, device="cpu")


def test_warm_mutants_rejected_like_native_engine():
    # 20 mutants of a warm container without checksum (truncations and
    # single-bit flips in the payloads): the port rejects exactly the
    # mutants the native engine rejects, and restores the same bytes
    # from the others
    data = corpus.texty(2 * 512, seed=5) + corpus.texty(700, seed=5)
    kw = dict(fmt="sqz4", blocks=True, blk_bits=9, win_bits=WIN, warm=True,
              checksum=False, parse="exact")
    blob = sqz_tpu.compress(data, engine="native", **kw)
    assert not all(sqzt.unpack(blob)[6])
    rng = np.random.default_rng(6)
    head = len(blob) - sum(map(len, sqzt.unpack(blob)[4]))
    mutants = [blob[:len(blob) - k] for k in (1, 7, 60)]
    for _ in range(17):
        m = bytearray(blob)
        m[int(rng.integers(head, len(m)))] ^= 1 << int(rng.integers(0, 8))
        mutants.append(bytes(m))
    rejected = 0
    for m in mutants:
        try:
            want = sqz_tpu.decompress(m, engine="native")
        except Exception:
            want = None
        try:
            got = sqz_tpu_torch.decompress(m, device="cpu")
        except Exception:
            got = None
        assert got == want
        rejected += want is None
    assert rejected >= 10


def test_blk_bits_17_takes_the_host_route():
    # (the name is kept from when a host route served these blocks)
    # sqz4 at 128 KiB blocks no longer takes a host route: it is the card's
    # route above 64 KiB (the reference's scan route: exact tokens and model
    # statistics on the host, the stats-fed encoder, the decoder cold and
    # seeded), here on the plain versions, counted in engine.wide_blocks.
    # Two blocks, a full one of pseudo-text and 16 KiB: the plain decoder
    # steps through every op of the full block.
    data = corpus.texty(WIDE_BYTES, seed=3)
    kw = dict(fmt="sqz4", blocks=True, blk_bits=17, win_bits=15)
    before = engine.wide_blocks
    got = sqz_tpu_torch.compress(data, device="cpu", **kw)
    assert engine.wide_blocks == before + 2
    assert len(got) == 19073
    assert got == sqz_tpu.compress(data, engine="native", parse="exact",
                                   **kw)
    assert got == sqz_tpu.compress(data, engine="tpu", parse="exact", **kw)
    assert sqz_tpu_torch.decompress(got, device="cpu") == data
    assert sqz_tpu.decompress(got, engine="native") == data
    assert engine.wide_blocks == before + 4
    # warm (v2; block 1 seeded) and anchored (v3) containers
    warm = sqz_tpu_torch.compress(data, warm=True, device="cpu", **kw)
    assert sqzt.unpack(warm)[6] == [True, False]
    assert warm == sqz_tpu.compress(data, engine="native", warm=True,
                                    parse="exact", **kw)
    assert warm == sqz_tpu.compress(data, engine="tpu", warm=True,
                                    parse="exact", **kw)
    assert sqz_tpu_torch.decompress(warm, device="cpu") == data
    v3 = sqz_tpu.compress(data, engine="native", warm="anchors", **kw)
    assert sqz_tpu_torch.decompress(v3, device="cpu") == data
    assert sqz_tpu_torch.compress(data, warm="anchors", parse="exact",
                                  device="cpu", **kw) == v3
