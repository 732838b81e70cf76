"""The route above 64 KiB blocks against the benchmark's plain references
(``portbench/reference``), which import nothing of the program: texty
at ``blk_bits`` 17, two full blocks and a partial one, ``win_bits`` 15,
cold, so that the 32 KiB window slides across whole blocks. The host's
exact tokens and per-op statistics (``sqz4_host.op_stream_stats``)
through the plain stats-fed encoder (``sqz4_ref.encode_stats_ref``) give
each block the plain exact-parse encoder's payload, and the plain
decoder gives the block back. Then the route's stages: the exact tokens
and the statistics each a stage of their own.

Tolerance is zero: payloads and restored bytes must be equal byte for
byte. The plain stats-fed encoder steps once a coded op, about 99,000
times at these blocks (~25 s)."""

import time

import torch

from portbench.inputs.texty import texty
from portbench.reference import sqz4 as ref_sqz4
from portbench.reference import sqz4_exact
from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host, sqz4_ref

# the plain versions step over small tensors: one intra-op thread each,
# so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

BLK, WIN = 17, 15
BS = 1 << BLK


def _blocks(data: bytes):
    return [data[i:i + BS] for i in range(0, len(data), BS)]


def test_wide_route_codes_the_plain_exact_parse():
    data = texty(2 * BS + 40_000, seed=2 ** 33 + 17)
    cols = host.op_stream_stats(data, 1 << WIN, BLK)
    # a lane a block, no pad lanes: the lanes code apart, and fewer make
    # each of the plain encoder's steps cheaper
    inputs = sqz4_cuda.pack_group_stats(cols, torch.device("cpu"), 3)
    words, lens = sqz4_ref.encode_stats_ref(
        *inputs, host.cap_words_for(2 * BS + 4096))
    got = sqz4_cuda.fetch_payloads(words, lens, 3)
    blocks = _blocks(data)
    assert [len(b) for b in blocks] == [BS, BS, 40_000]
    assert got == [sqz4_exact.encode_block(b, 1 << WIN) for b in blocks]
    assert [ref_sqz4.decode_block(p, len(b))
            for p, b in zip(got, blocks)] == blocks


def test_wide_route_stages_split_the_statistics(monkeypatch):
    # the exact tokens (stage "plan") and the per-op statistics computed
    # from the uploaded op words ("model", after "upload") each hold their
    # function's time, no stage is counted twice, and the host's per-block
    # loop is not called
    took = {}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            took[name] = took.get(name, 0.0) + time.perf_counter() - t
            return out
        return run

    def no_host_stats(*a, **k):
        raise AssertionError("the route called sqz4_host.op_stats")

    monkeypatch.setattr(host, "exact_op_streams",
                        timed("plan", host.exact_op_streams))
    monkeypatch.setattr(sqz4_cuda, "model_stats",
                        timed("model", sqz4_cuda.model_stats))
    monkeypatch.setattr(host, "op_stats", no_host_stats)
    data = texty(3 * 1024 + 500, seed=5)
    st = {}
    t = time.perf_counter()
    got = sqz4_cuda.encode_data_stats(data, 10, 1 << 10, True,
                                      device="cpu", stats=st)
    wall = time.perf_counter() - t
    assert got == [sqz4_exact.encode_block(b, 1 << 10)
                   for b in (data[i:i + 1024]
                             for i in range(0, len(data), 1024))]
    assert list(st) == ["plan_s", "upload_s", "model_s", "kernel_s",
                        "fetch_s"]
    assert st["plan_s"] >= took["plan"] > 0
    assert st["model_s"] >= took["model"] > 0
    assert sum(st.values()) <= wall
