"""The port's pipelined encode (planner thread + per-group device work,
plain PyTorch versions on the CPU) against the JAX package's pipeline in
interpret mode, the port's serial path and the native engine, and the
engine's route through it. Tolerance is zero: payloads and containers
must be equal."""

import threading

import pytest
import torch

import sqz_tpu_torch
from sqz_tpu.ops.pipeline import encode_data_pipelined as ref_pipelined
from sqz_tpu_torch import native
from sqz_tpu_torch.formats import container
from sqz_tpu_torch.ops import engine, pipeline, sqz4_cuda, sqz4_host
from sqz_tpu_torch.utils import corpus

# the plain versions step over small tensors: one intra-op thread each,
# so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

BLK, LANES = 9, 32
BS = 1 << BLK
CAP = BS + 2048


def _data(n_blocks: int = 3 * LANES + 5) -> bytes:
    """Over three groups of text, zeros, incompressible and two-byte-period
    blocks, with a short last block."""
    return b"".join(
        (corpus.texty(BS, seed=b), corpus.zeros(BS),
         corpus.random_bytes(BS, seed=b), b"ab" * (BS // 2))[b % 4]
        for b in range(n_blocks)) + corpus.texty(BS // 3, seed=99)


def _planner_threads():
    return [t for t in threading.enumerate() if t.name == "sqz4-planner"]


def test_pipelined_encode_equals_reference_and_serial_path():
    data = _data()
    st = {}
    got = pipeline.encode_data_pipelined(data, BLK, 1 << 10, True, CAP,
                                         lanes=LANES, device="cpu", stats=st)
    assert got == ref_pipelined(data, BLK, 1 << 10, True, cap=CAP,
                                lanes=LANES, interpret=True, parse="fast",
                                transport="tok")
    assert got == sqz4_cuda.encode_data_full(data, BLK, 1 << 10, True, CAP,
                                             parse="fast", device="cpu")
    assert set(st) == {"plan_s", "wait_plan_s", "dispatch_s", "fence_s",
                       "fetch_s", "wall_s"}
    assert not _planner_threads()


def test_op_stream_transport_equals_serial_path():
    data = _data(2 * LANES + 3)
    got = pipeline.encode_data_pipelined(data, BLK, 1 << 10, True, CAP,
                                         parse="exact", lanes=LANES,
                                         device="cpu")
    assert got == sqz4_cuda.encode_data_full(data, BLK, 1 << 10, True, CAP,
                                             parse="exact", device="cpu")


@pytest.mark.parametrize("parse", ["fast", "exact"])
def test_one_group_equals_serial_path_and_native(parse):
    # fewer blocks than a group's lanes: one plan, one launch
    data = _data(7)
    got = pipeline.encode_data_pipelined(data, BLK, 1 << 10, True, CAP,
                                         parse=parse, device="cpu")
    assert got == sqz4_cuda.encode_data_full(data, BLK, 1 << 10, True, CAP,
                                             parse=parse, device="cpu")
    assert got == [native.sqz4_compress_payload(data[o:o + BS], 1 << 10,
                                                parse=parse)
                   for o in range(0, len(data), BS)]


def test_overflow_blocks_reroute_through_the_op_stream_kernel():
    data = _data()
    grp = sqz4_cuda.plan_tok_group(data[:LANES * BS], BLK, 1 << 10, True,
                                   tok_cap=64)
    assert grp.over and grp.fit                 # counts[b, 2] < 0 occurs
    got = pipeline.encode_data_pipelined(data, BLK, 1 << 10, True, CAP,
                                         lanes=LANES, device="cpu",
                                         tok_cap=64)
    assert got == sqz4_cuda.encode_data_full(data, BLK, 1 << 10, True, CAP,
                                             parse="fast", device="cpu")


def test_planner_error_is_raised_and_the_thread_exits(monkeypatch):
    calls = []
    plan = sqz4_cuda.plan_tok_group

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise OSError("planner failed")
        return plan(*a, **kw)

    monkeypatch.setattr(sqz4_cuda, "plan_tok_group", failing)
    with pytest.raises(OSError, match="planner failed"):
        pipeline.encode_data_pipelined(_data(), BLK, 1 << 10, True, CAP,
                                       lanes=LANES, device="cpu")
    assert not _planner_threads()


def test_main_loop_error_stops_the_planner(monkeypatch):
    def failing(*a, **kw):
        raise RuntimeError("device step failed")

    monkeypatch.setattr(sqz4_cuda, "encode_tok_group", failing)
    with pytest.raises(RuntimeError, match="device step failed"):
        pipeline.encode_data_pipelined(_data(), BLK, 1 << 10, True, CAP,
                                       lanes=LANES, device="cpu")
    assert not _planner_threads()


def _spy(monkeypatch, module, name, taken):
    """Record each call of <module>.<name> in ``taken``."""
    fn = getattr(module, name)

    def spied(*a, **kw):
        taken.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, spied)


def test_exact_parse_takes_the_op_stream_kernel(monkeypatch):
    taken = []
    _spy(monkeypatch, pipeline, "_encode_ops_group", taken)
    _spy(monkeypatch, sqz4_cuda, "encode_tok_group", taken)
    data = _data(LANES + 3)
    got = pipeline.encode_data_pipelined(data, BLK, 1 << 10, True, CAP,
                                         parse="exact", lanes=LANES,
                                         device="cpu")
    assert taken == ["_encode_ops_group"] * 2
    assert got == sqz4_cuda.encode_data_full(data, BLK, 1 << 10, True, CAP,
                                             parse="exact", device="cpu")


@pytest.mark.parametrize("nblocks,groups", [(40, 3), (5, 1)])
def test_compress_round_trips_through_the_engines_pipeline_branch(
        monkeypatch, nblocks, groups):
    """Containers of any block count (groups shrunk to 16 blocks here)
    encode through the pipeline, a plan a group, and decode through
    decode_groups; the bytes are the serial path's."""
    monkeypatch.setattr(engine, "LANES", 16)
    monkeypatch.setattr(sqz4_host, "LANES", 16)
    taken = []
    _spy(monkeypatch, pipeline, "encode_data_pipelined", taken)
    _spy(monkeypatch, sqz4_cuda, "plan_tok_group", taken)
    _spy(monkeypatch, sqz4_cuda, "decode_groups", taken)
    data = _data(nblocks)
    blob = sqz_tpu_torch.compress(data, blk_bits=BLK, win_bits=10,
                                  device="cpu")
    assert sqz_tpu_torch.decompress(blob, device="cpu") == data
    assert taken == (["encode_data_pipelined"] + ["plan_tok_group"] * groups
                     + ["decode_groups"])
    serial = sqz4_cuda.encode_data_full(data, BLK, 1 << 10, True, CAP,
                                        device="cpu")
    assert container.unpack(blob)[4] == serial
