"""The port's multi-device path (``sqz_tpu_torch/parallel``) on virtual
CPU meshes of 2, 4 and 8 shards (the plain versions, a host thread a
shard) against the JAX package's same functions on its virtual 8-device
CPU mesh (``tests/conftest.py``; Pallas in interpret mode, as
``tests/test_distributed.py`` runs them): the resident encode in every
mode, the resident restore under each assembly, the whole-buffer encode
cold and warm, the sharded decode and the token-list encode, on uneven
block counts; then the process group (a gloo exchange between two
processes, ``bootstrap`` without the environment), the dry run and the
checks of the mesh itself. Bytes must be equal: a lossless codec."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import sqz_tpu
import sqz_tpu_torch
from sqz_tpu import native as ref_native
from sqz_tpu.parallel import mesh as ref_mesh, shard as ref_shard
from sqz_tpu.utils import corpus
from sqz_tpu_torch import native
from sqz_tpu_torch.ops import resident
from sqz_tpu_torch.parallel import dryrun, multihost, shard
from sqz_tpu_torch.parallel.mesh import Mesh, check_mesh, make_mesh
from sqz_tpu_torch.utils import synthetic

# the plain versions step over small tensors: one intra-op thread each,
# so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHARDS = [2, 4, 8]
BB = 8            # 256-byte blocks, as the reference's mesh tests
CPU = torch.device("cpu")


def _mesh(n):
    return make_mesh(n, devices=[CPU] * n)


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return ref_mesh.make_mesh(8)


@pytest.fixture(scope="module")
def mix():
    # 11 blocks, the last a third long: uneven over every mesh
    return synthetic.resident_mix(11, BB, seed=3)


@pytest.fixture(scope="module")
def ref_resident(mesh8, mix):
    out = {}
    old = os.environ.get("SQZ_LZ_SORT_ROWS")
    os.environ["SQZ_LZ_SORT_ROWS"] = "2"     # the reference's tiny runs
    try:
        for mode in ("lit", "rle", "lz"):
            out[mode] = ref_shard.encode_resident_sharded(
                mix, BB, mesh8, mode=mode, lanes=128, interpret=True)
    finally:
        if old is None:
            os.environ.pop("SQZ_LZ_SORT_ROWS")
        else:
            os.environ["SQZ_LZ_SORT_ROWS"] = old
    return out


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("mode", ["lit", "rle", "lz"])
def test_resident_encode_equals_the_reference(mix, ref_resident, mode, n):
    got = shard.encode_resident_sharded(mix, BB, _mesh(n), mode=mode)
    assert got == ref_resident[mode]
    assert len(got) == 11
    # and as a tensor, through the entry point
    x = torch.frombuffer(bytearray(mix), dtype=torch.uint8)
    assert sqz_tpu_torch.compress_resident(x, blk_bits=BB, mode=mode,
                                           mesh=_mesh(n)) == \
        sqz_tpu_torch.compress_resident(mix, blk_bits=BB, mode=mode,
                                        device="cpu")


@pytest.fixture(scope="module")
def rle_blob(mix):
    return sqz_tpu.compress_resident(mix, blk_bits=BB, mode="rle",
                                     interpret=True)


@pytest.fixture(scope="module")
def ref_restore(mesh8, rle_blob):
    return np.asarray(ref_shard.decompress_resident_sharded(
        rle_blob, mesh8, lanes=128, interpret=True)).tobytes()


@pytest.mark.parametrize("assembly,n", [("auto", 2), ("auto", 4),
                                        ("auto", 8), ("cell", 4),
                                        ("general", 4)])
def test_resident_restore_equals_the_reference(mix, rle_blob, ref_restore,
                                               assembly, n):
    # the reference's mesh restore drops ``assembly`` (sqz_tpu/api.py);
    # the port's keeps it: the same routes as the mesh-less restore
    assert ref_restore == mix
    before = dict(resident.route_lanes)
    single = sqz_tpu_torch.decompress_resident(rle_blob, assembly=assembly,
                                               device="cpu")
    routes = {k: resident.route_lanes[k] - before[k] for k in before}
    before = dict(resident.route_lanes)
    got = sqz_tpu_torch.decompress_resident(rle_blob, mesh=_mesh(n),
                                            assembly=assembly)
    assert {k: resident.route_lanes[k] - before[k] for k in before} == \
        routes
    assert got.dtype == torch.uint8 and got.device == CPU
    assert got.numpy().tobytes() == single.numpy().tobytes() == ref_restore
    assert routes["general" if assembly == "general" else "cell"] == 11


@pytest.fixture(scope="module")
def text():
    return corpus.texty(9 * 256 + 77, seed=4)     # 10 blocks, uneven


@pytest.fixture(scope="module")
def ref_data(mesh8, text):
    return {warm: ref_shard.encode_data_sharded_pallas(
        text, BB, 1 << 8, mesh8, lanes=128, tc=64, interpret=True,
        warm=warm) for warm in (False, True)}


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("warm", [False, True])
def test_data_encode_equals_the_reference(text, ref_data, warm, n):
    got = shard.encode_data_sharded(text, BB, 1 << 8, _mesh(n), warm=warm)
    assert got == ref_data[warm]
    if not warm:
        assert got == [ref_native.sqz4_compress_payload(
            text[i:i + 256], 1 << 8, lz=True)
            for i in range(0, len(text), 256)]


@pytest.mark.parametrize("n", SHARDS)
def test_decode_equals_the_reference_and_rejects_a_corrupt_block(mesh8, n):
    data = corpus.texty(5 * 512 + 100, seed=8)
    payloads = native.blocks_compress(data, 1, 10, 9)
    sizes = [min(512, len(data) - i) for i in range(0, len(data), 512)]
    got = shard.decode_blocks_sharded(payloads, sizes, 9, _mesh(n))
    assert got == ref_shard.decode_blocks_sharded(payloads, sizes, 9, mesh8)
    assert b"".join(got) == data
    bad = list(payloads)
    bb = bytearray(bad[3])
    bb[len(bb) // 2] ^= 0x80
    bad[3] = bytes(bb)
    with pytest.raises(ValueError, match="3"):
        shard.decode_blocks_sharded(bad, sizes, 9, _mesh(n))


@pytest.fixture(scope="module")
def tokens():
    blocks = [corpus.texty(128 + 16 * i, seed=i) for i in range(11)]
    toks = [[("lit", b) for b in blk] for blk in blocks]
    # matches too: the reference's micro-op grammar for them
    toks[2] = toks[2][:40] + [("match", 30, 17), ("match", 4, 1)] \
        + toks[2][40:]
    return toks


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("warm", [False, True])
def test_token_encode_equals_the_reference(mesh8, tokens, warm, n):
    from sqz_tpu.ops.sqz4_jax import seed_from_tokens
    seeds = None
    if warm:
        seed = seed_from_tokens(tokens[0])
        seeds = [None] + [seed] * (len(tokens) - 1)
    want = ref_shard.encode_blocks_sharded(tokens, BB, mesh8, seeds=seeds)
    assert shard.encode_blocks_sharded(tokens, BB, _mesh(n),
                                       seeds=seeds) == want


def test_token_encode_takes_one_warm_seed():
    toks = [[("lit", 1)] * 5, [("lit", 2)] * 5, [("lit", 3)] * 5]
    _, s1 = native.sqz4_compress_payload(b"\1" * 5, 256, lz=False,
                                         return_state=True)
    _, s2 = native.sqz4_compress_payload(b"\2" * 9, 256, lz=False,
                                         return_state=True)
    with pytest.raises(ValueError, match="one warm seed"):
        shard.encode_blocks_sharded(toks, BB, _mesh(2), seeds=[None, s1, s2])


@pytest.mark.parametrize("nb,n,lanes", [(1, 8, 512), (11, 2, 512),
                                        (11, 4, 2), (512, 4, 512),
                                        (22786, 2, 512), (7, 3, 4)])
def test_shard_ranges_cover_every_block_once(nb, n, lanes):
    width, ranges = shard.shard_ranges(nb, n, lanes)
    assert len(ranges) == n and 1 <= width <= lanes
    assert [b for a, z in ranges for b in range(a, z)] == list(range(nb))
    # every shard with blocks starts on a launch boundary of its own
    assert all(a % width == 0 for a, z in ranges if a < z)


def test_meshes_are_checked():
    m = _mesh(3)
    assert isinstance(m, Mesh) and m.size == 3 and m.world == 1
    assert m.streams == (None, None, None)
    assert check_mesh(m) is m
    with pytest.raises(TypeError, match="Mesh"):
        check_mesh(object())
    with pytest.raises(TypeError, match="Mesh"):
        shard.encode_resident_sharded(b"abc", BB, [CPU, CPU])
    with pytest.raises(ValueError):
        make_mesh(3, devices=[CPU] * 2)
    with pytest.raises(ValueError):
        Mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()


def test_exchange_rows_roundtrip_two_processes():
    # the reference's simulation of a 2-process exchange, on the copies
    rng = np.random.default_rng(3)
    payloads = [rng.integers(0, 256, int(k), np.uint8).tobytes()
                for k in rng.integers(1, 40, 9)]
    lens = np.array([len(p) for p in payloads], np.int64)
    ids0, row0 = multihost.pack_exchange_row(
        [(b, payloads[b]) for b in range(0, 9, 2)], lens)
    ids1, row1 = multihost.pack_exchange_row(
        [(b, payloads[b]) for b in range(1, 9, 2)], lens)
    max_n, max_b = max(ids0.size, ids1.size), max(row0.size, row1.size)
    all_ids = np.stack([np.concatenate([i, np.full(max_n - i.size, -1)])
                        for i in (ids0, ids1)])
    all_buf = np.stack([np.concatenate([r, np.zeros(max_b - r.size,
                                                    np.uint8)])
                        for r in (row0, row1)])
    assert multihost.unpack_exchange_rows(all_ids, all_buf, lens, 9) == \
        payloads
    pairs = [(2, b"cc"), (0, b"aaa"), (1, b"b")]
    assert multihost.gather_payloads_to_host0(pairs, [3, 1, 2], 3) == \
        [b"aaa", b"b", b"cc"]
    with pytest.raises(ValueError, match="missing"):
        multihost.gather_payloads_to_host0(pairs[:2], [3, 1, 2], 3)


def test_bootstrap_is_a_noop_without_the_environment(monkeypatch):
    for k in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert multihost.bootstrap() is False
    assert not torch.distributed.is_initialized()
    assert multihost.world() == (0, 1)
    assert multihost.failed_ranks(True) == []
    assert multihost.all_gather_lengths([4, 5], [2]).tolist() == [4, 5]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_exchange(tmp_path):
    """Two processes (gloo on a localhost port), a CPU shard each:
    ``compress_resident(mesh=)`` gives rank 0 the single-process
    container (and rank 1 None, checked in the worker), and the restore
    over the group gives both ranks the input."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sqz_tpu_torch.parallel.dryrun", "--rank",
         str(r), "--world", "2", "--port", str(port), "--backend", "gloo",
         "--device", "cpu", "--blocks", "6", "--blk-bits", "9", "--out",
         str(tmp_path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    data = synthetic.resident_mix(6, 9, seed=1)
    assert (tmp_path / "rle.sqzt").read_bytes() == \
        sqz_tpu_torch.compress_resident(data, blk_bits=9, mode="rle",
                                        device="cpu")
    assert "rank 1 of 2 (gloo, cpu)" in outs[1]


def test_dryrun_entry_and_multichip_on_the_cpu(capsys):
    fn, args = dryrun.entry("cpu")
    words, lens = fn(*args)
    assert words.shape[2] == 8 and lens.shape == (1, 8, 8)
    assert (lens[0, 0] > 0).all()
    dryrun.dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip(4)" in capsys.readouterr().out
