"""The port's host stages (``ops/launch.py`` ``Stages``) on the CPU: under
``torch.profiler`` every stage of a call is a ``sqz.<layer>.<stage>``
range nested in the call's; with the profiler off and no ``stats``
dict no range is opened; the ``stats`` dicts keep their keys, and the
checkpoint's and the container's stages write nothing into them."""

import json

import pytest
import torch

import sqz_tpu_torch
from sqz_tpu_torch import native
from sqz_tpu_torch.ops import launch, pipeline, sqz4_cuda
from sqz_tpu_torch.utils import checkpoint, corpus

torch.set_num_threads(1)

BLK, LANES = 9, 4
BS = 1 << BLK
CALLER = "caller"


def _profiled(fn, tmp_path, all_threads=False):
    """Run ``fn`` in a range named CALLER under the CPU profiler; returns
    (its result, the trace's ranges as (name, start, end, thread))."""
    cfg = (torch.profiler._ExperimentalConfig(profile_all_threads=True)
           if all_threads else None)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=cfg) as prof:
        with torch.profiler.record_function(CALLER):
            out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"])
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    return out, spans


def _check_nested(spans, same_thread=True):
    """Every ``sqz.`` range lies inside the CALLER range (on its thread
    unless ``same_thread`` is False); returns the names in start order."""
    (c0, c1, ctid), = [(s, e, t) for n, s, e, t in spans if n == CALLER]
    mine = sorted((s, n, e, t) for n, s, e, t in spans
                  if n.startswith("sqz."))
    for s, n, e, t in mine:
        assert c0 <= s and e <= c1, n
        if same_thread:
            assert t == ctid, n
    return [n for _, n, _, _ in mine]


def _in_order(names, expected):
    """``expected`` appear in ``names`` in this order (first starts)."""
    firsts = [names.index(x) for x in expected]
    assert firsts == sorted(firsts), names


def _texty_blocks(n):
    return corpus.texty(n * BS, seed=5) + corpus.texty(BS // 3, seed=6)


def test_pipeline_spans_nest_in_the_call(tmp_path):
    data = _texty_blocks(3 * LANES)
    st = {}
    _, spans = _profiled(lambda: pipeline.encode_data_pipelined(
        data, BLK, 1 << 10, True, BS + 2048, lanes=LANES, device="cpu",
        stats=st), tmp_path, all_threads=True)
    (ctid,) = {t for n, _, _, t in spans if n == CALLER}
    names = _check_nested(spans, same_thread=False)
    main = [n for n, _, _, t in sorted(spans, key=lambda x: x[1])
            if t == ctid and n.startswith("sqz.")]
    planner = {t for n, _, _, t in spans if n == "sqz.pipeline.plan"}
    # one plan a group, on the planner thread; the rest on the caller's
    assert names.count("sqz.pipeline.plan") == 4 and ctid not in planner
    assert set(main) == {"sqz.pipeline.wait_plan", "sqz.pipeline.dispatch",
                         "sqz.pipeline.fence", "sqz.pipeline.fetch"}
    _in_order(main, ["sqz.pipeline.wait_plan", "sqz.pipeline.dispatch",
                     "sqz.pipeline.fence", "sqz.pipeline.fetch"])
    assert set(st) == {"plan_s", "wait_plan_s", "dispatch_s", "fence_s",
                       "fetch_s", "wall_s"}
    assert all(v >= 0 for v in st.values())


def test_decode_groups_spans_nest_in_the_call(tmp_path):
    data = _texty_blocks(5)
    payloads = native.blocks_compress(data, 1, 10, BLK)
    sizes = [len(data[o:o + BS]) for o in range(0, len(data), BS)]
    out, spans = _profiled(lambda: sqz4_cuda.decode_groups(
        payloads, sizes, BLK, device="cpu", lanes=LANES), tmp_path)
    assert b"".join(out) == data
    names = _check_nested(spans)
    stages = ["sqz.decode.upload", "sqz.decode.pack", "sqz.decode.kernel",
              "sqz.decode.fetch", "sqz.decode.assemble"]
    assert names == stages


def test_compress_and_decompress_spans_nest_in_the_call(tmp_path):
    data = _texty_blocks(3)
    kw = dict(blk_bits=BLK, win_bits=10, device="cpu")
    blob, spans = _profiled(lambda: sqz_tpu_torch.compress(data, **kw),
                            tmp_path)
    names = _check_nested(spans)
    # one group through the pipeline: its plan runs on the planner thread,
    # and the caller's second wait receives the planner's end
    assert names == ["sqz.container.split", "sqz.container.join",
                     "sqz.pipeline.wait_plan", "sqz.pipeline.dispatch",
                     "sqz.pipeline.fence", "sqz.pipeline.fetch",
                     "sqz.pipeline.wait_plan", "sqz.container.checksum",
                     "sqz.container.pack"]
    back, spans = _profiled(lambda: sqz_tpu_torch.decompress(
        blob, device="cpu"), tmp_path)
    assert back == data
    names = _check_nested(spans)
    assert names == ["sqz.container.unpack", "sqz.decode.upload",
                     "sqz.decode.pack", "sqz.decode.kernel",
                     "sqz.decode.fetch", "sqz.decode.assemble",
                     "sqz.container.join", "sqz.container.checksum"]


def test_wide_route_spans_split_the_statistics(tmp_path):
    # above 64 KiB blocks the host's exact tokens and the per-op
    # statistics are sibling stages, the op words' upload between them
    data = corpus.texty(1500, seed=3)
    blob, spans = _profiled(lambda: sqz_tpu_torch.compress(
        data, blk_bits=17, win_bits=10, device="cpu"), tmp_path)
    names = _check_nested(spans)
    assert names == ["sqz.container.split", "sqz.container.join",
                     "sqz.encode.plan", "sqz.encode.upload",
                     "sqz.encode.model", "sqz.encode.kernel",
                     "sqz.encode.fetch", "sqz.container.checksum",
                     "sqz.container.pack"]
    (p1,), (m0,) = ([e for n, _, e, _ in spans if n == "sqz.encode.plan"],
                    [s for n, s, _, _ in spans if n == "sqz.encode.model"])
    assert p1 <= m0
    assert sqz_tpu_torch.decompress(blob, device="cpu") == data


def test_checkpoint_spans_nest_in_the_call(tmp_path):
    tree = {"w": torch.randn(300, generator=torch.Generator().manual_seed(1)),
            "n": torch.arange(40, dtype=torch.int32)}
    path = tmp_path / "t.ckpt"
    kw = dict(blk_bits=BLK, device="cpu")
    _, spans = _profiled(lambda: checkpoint.save_pytree(tree, path, **kw),
                         tmp_path)
    names = _check_nested(spans)
    assert set(names) == {"sqz.checkpoint.filter", "sqz.resident.parse",
                          "sqz.resident.kernel", "sqz.resident.fetch",
                          "sqz.checkpoint.write"}
    _in_order(names, ["sqz.checkpoint.filter", "sqz.resident.parse",
                      "sqz.resident.kernel", "sqz.resident.fetch",
                      "sqz.checkpoint.write"])
    back, spans = _profiled(lambda: checkpoint.load_pytree(
        path, device="cpu"), tmp_path)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    names = _check_nested(spans)
    assert names == ["sqz.checkpoint.read", "sqz.resident.unpack",
                     "sqz.resident.upload", "sqz.resident.pack",
                     "sqz.resident.kernel", "sqz.resident.cell",
                     "sqz.checkpoint.leaves"]


def test_no_range_without_a_profiler(monkeypatch, tmp_path):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    assert launch.Stages("x").stage("y") is launch.Stages("z").stage("w")
    data = _texty_blocks(3 * LANES)
    st = {}
    pipeline.encode_data_pipelined(data, BLK, 1 << 10, True, BS + 2048,
                                   lanes=LANES, device="cpu", stats=st)
    blob = sqz_tpu_torch.compress(data[:3 * BS], blk_bits=BLK, win_bits=10,
                                  device="cpu")
    sqz_tpu_torch.decompress(blob, device="cpu")
    tree = {"w": torch.arange(200, dtype=torch.float32)}
    save_st, load_st = {}, {}
    checkpoint.save_pytree(tree, tmp_path / "t.ckpt", blk_bits=BLK,
                           device="cpu", stats=save_st)
    checkpoint.load_pytree(tmp_path / "t.ckpt", device="cpu", stats=load_st)
    assert entered == []
    # the stats dicts keep their keys: the codec's stages alone, none of
    # the checkpoint's or the container's
    assert set(save_st) == {"parse_s", "kernel_s", "fetch_s"}
    assert set(load_st) == {"pack_s", "upload_s", "kernel_s", "cell_s"}
    assert set(st) == {"plan_s", "wait_plan_s", "dispatch_s", "fence_s",
                       "fetch_s", "wall_s"}


def test_stages_time_and_name(tmp_path):
    st = {}
    stages = launch.Stages("t", st)

    def run():
        for _ in range(2):
            with stages.stage("a"):
                with stages.stage("b"):
                    pass
        with pytest.raises(KeyError):
            with stages.stage("c"):
                raise KeyError("c")

    _, spans = _profiled(run, tmp_path)
    # accumulated, and a stage that raised is not timed
    assert set(st) == {"a_s", "b_s"} and st["a_s"] >= st["b_s"] >= 0
    names = _check_nested(spans)
    assert names == ["sqz.t.a", "sqz.t.b"] * 2 + ["sqz.t.c"]
    (a0, a1), (b0, b1) = [(s, e) for n, s, e, _ in sorted(
        spans, key=lambda x: x[1]) if n in ("sqz.t.a", "sqz.t.b")][:2]
    assert a0 <= b0 and b1 <= a1
