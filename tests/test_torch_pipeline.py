"""The port's pipelined encode (planner thread + per-group device work,
plain PyTorch versions on the CPU) against the JAX package's pipeline in
interpret mode and the port's serial path, and the engine's dispatch to
it. Tolerance is zero: payloads and containers must be equal."""

import threading

import pytest
import torch

import sqz_tpu_torch
from sqz_tpu.ops.pipeline import encode_data_pipelined as ref_pipelined
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


@pytest.mark.parametrize("transport,parse", [("ops", "fast"),
                                             ("ops", "exact")])
def test_op_stream_transport_equals_serial_path(transport, parse):
    data = _data(2 * LANES + 3)
    got = pipeline.encode_data_pipelined(data, BLK, 1 << 10, True, CAP,
                                         parse=parse, lanes=LANES,
                                         device="cpu", transport=transport)
    assert got == sqz4_cuda.encode_data_full(data, BLK, 1 << 10, True, CAP,
                                             parse=parse, device="cpu")


@pytest.mark.parametrize("fetch", ["compact", "trim"])
def test_overflow_blocks_reroute_through_the_op_stream_kernel(
        monkeypatch, fetch):
    monkeypatch.setenv("SQZ_FETCH", fetch)
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


def test_token_transport_rejects_the_exact_parse(monkeypatch):
    monkeypatch.setenv("SQZ_TRANSPORT", "tok")
    with pytest.raises(ValueError):
        pipeline.encode_data_pipelined(b"x" * 100, BLK, 1 << 10, True, CAP,
                                       parse="exact", device="cpu")


def _spy(monkeypatch, name, taken):
    """Record each call of pipeline.<name> in ``taken``."""
    fn = getattr(pipeline, name)

    def spied(*a, **kw):
        taken.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(pipeline, name, spied)


@pytest.mark.parametrize("env", [None, "0"])
def test_compress_round_trips_through_the_engines_pipeline_branch(
        monkeypatch, env):
    """Containers of more than one group (shrunk to 16 blocks here) encode
    through the pipeline unless SQZ_PIPELINE=0; both give the same bytes
    and decode through decode_data_pipelined."""
    monkeypatch.setattr(engine, "LANES", 16)
    monkeypatch.setattr(sqz4_host, "LANES", 16)
    if env is None:
        monkeypatch.delenv("SQZ_PIPELINE", raising=False)
    else:
        monkeypatch.setenv("SQZ_PIPELINE", env)
    taken = []
    for name in ("encode_data_pipelined", "decode_data_pipelined"):
        _spy(monkeypatch, name, taken)
    data = _data(40)
    blob = sqz_tpu_torch.compress(data, blk_bits=BLK, win_bits=10,
                                  device="cpu")
    assert sqz_tpu_torch.decompress(blob, device="cpu") == data
    want = ["decode_data_pipelined"]
    if env is None:
        want.insert(0, "encode_data_pipelined")
    assert taken == want
    serial = sqz4_cuda.encode_data_full(data, BLK, 1 << 10, True, CAP,
                                        device="cpu")
    assert container.unpack(blob)[4] == serial
