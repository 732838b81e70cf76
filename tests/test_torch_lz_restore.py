"""The port's general restore (``sqz_tpu_torch/ops/lz_restore.py``, on
the CPU) against the JAX package's (``sqz_tpu/ops/lz_restore.py``, its
decoder in interpret mode): blocks and bad flags of device-LZ payloads,
of host-parsed ones and of corrupt mutants, and ``decompress_resident``
with the general assembly. Tolerance is zero throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqz_tpu
import sqz_tpu_torch
from sqz_tpu import native
from sqz_tpu.formats import container as sqzt
from sqz_tpu.formats.constants import SQZT_FORMAT_SQZ4
from sqz_tpu.ops import lz_restore as ref
from sqz_tpu.ops import resident as ref_resident
from sqz_tpu.ops import sqz4_pallas as sp
from sqz_tpu.utils import corpus
from sqz_tpu_torch.ops import lz_restore, resident

# the plain versions step over small tensors: one intra-op thread each,
# so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

LANES = 128   # the reference decoder's lane multiple


def _restore_both(payloads, sizes, blk):
    """decode_lz_group on one group, port and reference: ((blocks, bad),
    (blocks, bad)) as numpy."""
    bs = 1 << blk
    plan = sp.plan_decode_dispatch(LANES, blk, lanes=LANES, slots=1,
                                   interpret=True)
    buf, plens, szs, _o = ref_resident.pack_payload_group(
        payloads, sizes, plan["Pw"], LANES)
    wb, _c, wbad = ref.decode_lz_group(
        jnp.asarray(buf), jnp.asarray(plens), jnp.asarray(szs),
        Pw=plan["Pw"], t_max=plan["t_max"], lw=plan["lw"], tw=plan["tw"],
        mw=plan["mw"], bs=bs, interpret=True, wide=False)
    pbuf, pplens, pszs, _o = resident.pack_payload_group(
        payloads, sizes, plan["Pw"], LANES)
    gb, _c, gbad = lz_restore.decode_lz_group(
        torch.from_numpy(pbuf.view(np.int32)).view(torch.uint32),
        torch.from_numpy(pplens), torch.from_numpy(pszs),
        resident.decoder_args(blk, LANES), bs)
    return (gb.numpy(), gbad.numpy()), (np.asarray(wb), np.asarray(wbad))


def _assert_equal(got, want, n):
    np.testing.assert_array_equal(got[1][:n], want[1][:n])
    for b in np.nonzero(~want[1][:n])[0]:
        np.testing.assert_array_equal(got[0][b], want[0][b])


def test_general_restore_equals_the_reference():
    # device-LZ payloads, host exact-parse payloads (distances up to the
    # window, chains of overlapped copies) and one short block
    blk = 10
    bs = 1 << blk
    data = (corpus.texty(6 * bs, seed=1) + bytes(bs) + b"ab" * bs
            + b"Q" * 900)
    parts = [data[o:o + bs] for o in range(0, len(data), bs)]
    lz = ref_resident.encode_resident_blocks(data, blk, "lz", lanes=32,
                                             interpret=True)
    exact = [native.sqz4_compress_payload(p, 1 << 15, lz=True)
             for p in parts]
    payloads = lz + exact
    sizes = [len(p) for p in parts] * 2
    got, want = _restore_both(payloads, sizes, blk)
    _assert_equal(got, want, len(payloads))
    assert not want[1][:len(payloads)].any()
    assert b"".join(got[0][b, :sizes[b]].tobytes()
                    for b in range(len(parts))) == data


def test_corrupt_mutants_flag_or_match():
    # tests/test_lz_restore.py:119: for a mutated payload the assembly
    # flags the lane or restores it, the same lanes as the reference, and
    # a lane it restores equals the host codec's bytes
    blk, bs = 8, 256
    data = corpus.texty(8 * bs, seed=21) + bytes(300) + b"pqr" * 150
    payloads = ref_resident.encode_resident_blocks(data, blk, "lz",
                                                   lanes=32, interpret=True)
    sizes = [min(bs, len(data) - b * bs) for b in range(len(payloads))]
    rng = np.random.default_rng(5)
    muts = []
    for _ in range(24):
        b = int(rng.integers(len(payloads)))
        p = bytearray(payloads[b])
        p[int(rng.integers(len(p)))] ^= int(rng.integers(1, 256))
        muts.append((bytes(p), sizes[b]))
    got, want = _restore_both([m[0] for m in muts], [m[1] for m in muts],
                              blk)
    _assert_equal(got, want, len(muts))
    matched = 0
    for i, (mp, sz) in enumerate(muts):
        try:
            host = native.sqz4_decompress_payload(mp, sz)
        except Exception:
            continue
        if not got[1][i]:
            assert got[0][i, :sz].tobytes() == host
            matched += 1
    assert matched >= 1 and got[1][:len(muts)].any()


@pytest.mark.parametrize("assembly", ["general", "auto"])
def test_lz_container_restores_on_the_device_path(assembly, monkeypatch):
    # tests/test_lz_restore.py:33-60: an LZ container restores with no
    # host lane (the host codec poisoned), by the general assembly
    data = (corpus.texty(6 * 256, seed=1) + b"abcab" * 100 + bytes(300)
            + corpus.texty(512, seed=2))
    blob = sqz_tpu_torch.compress_resident(data, blk_bits=8, mode="lz",
                                           lanes=32, device="cpu")

    def boom(*a, **k):
        raise AssertionError("host decode on a valid stream")
    monkeypatch.setattr(resident, "host_decode_blocks", boom)
    before = dict(resident.route_lanes)
    out = sqz_tpu_torch.decompress_resident(blob, lanes=LANES,
                                            assembly=assembly, device="cpu")
    assert out.numpy().tobytes() == data
    moved = {k: resident.route_lanes[k] - before[k] for k in before}
    assert moved["general"] > 0 and moved["host"] == 0
    assert moved["general"] + moved["cell"] == len(sqzt.unpack(blob)[4])


def test_foreign_streams_restore_like_the_reference():
    # host exact-parse payloads in a container the resident encoder did
    # not write (tests/test_lz_restore.py:70), and a corrupt one raises
    data = corpus.texty(4 * 1024, seed=7) + b"0123456789" * 60
    parts = [data[o:o + 1024] for o in range(0, len(data), 1024)]
    payloads = [native.sqz4_compress_payload(p, 1 << 15) for p in parts]
    blob = sqzt.pack(SQZT_FORMAT_SQZ4, 15, 10, len(data), payloads, None)
    want = np.asarray(sqz_tpu.decompress_resident(
        blob, interpret=True, lanes=LANES, assembly="general"))
    got = sqz_tpu_torch.decompress_resident(blob, lanes=LANES,
                                            assembly="general", device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().tobytes() == data
    bad = bytearray(blob)
    bad[-7] ^= 0x5A
    with pytest.raises((ValueError, OSError)):
        sqz_tpu_torch.decompress_resident(bytes(bad), lanes=LANES,
                                          assembly="general", device="cpu")
