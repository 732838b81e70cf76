"""The readers of the program's spans (``span_idle.py`` and the metrics
that use it) on a synthetic trace, and the exact-parse compress cell: its
traffic, its metrics, the plain exact-parse encoder its check holds the
blocks to, and its run on the CPU through the plain versions at a small
size."""

import random

import pytest

from portbench import control, faults, harness, span_idle, trace
from portbench.entries import compress_exact
from portbench.inputs.texty import texty
from portbench.reference import sqz4 as ref_sqz4
from portbench.reference import sqz4_exact
from portbench.reference import sqzt as ref_sqzt

CELL = "text100m-sqz4.compress-exact"
SPAN_METRICS = ("plan_wait_idle_s.enc", "ckpt_write_idle_s.enc",
                "ckpt_read_idle_s.dec")


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _events(spans=True):
    """Two compress calls in a window of 10 ms, the card's four kernels
    between the host's stages, which are ``sqz.*`` ranges unless
    ``spans`` is False (a program that opens none)."""
    host = [("sqz.container.split", 0, 500),
            ("sqz.pipeline.wait_plan", 600, 1400),
            ("sqz.container.pack", 3000, 1000),
            ("sqz.pipeline.wait_plan", 4100, 1900)]
    events = [_ev(trace.WINDOW, "user_annotation", 0, 10000),
              _ev("compress", "user_annotation", 0, 4000),
              _ev("compress", "user_annotation", 4000, 4000),
              _ev("k", "kernel", 500, 100, tid=7),
              _ev("k", "kernel", 2000, 1000, tid=7),
              _ev("k", "kernel", 4000, 100, tid=7),
              _ev("k", "kernel", 6000, 2000, tid=7)]
    if spans:
        events += [_ev(n, "user_annotation", s, d) for n, s, d in host]
    return events


def _t(events):
    s = trace.summarize(events, spans=("compress",))
    return dict(calls=[{}, {}], trace=s)


def test_span_readers_by_hand():
    t = _t(_events())
    gaps = dict(t["trace"]["idle_gaps"])
    # each gap goes to the innermost range over its middle
    assert gaps == pytest.approx({
        "compress: sqz.container.split": 500e-6,
        "compress: sqz.pipeline.wait_plan": 3300e-6,
        "compress: sqz.container.pack": 1000e-6,
        "between calls: host code": 2000e-6})
    # seconds a call of 2 calls; a stage the trace does not hold reads 0
    want = {"plan_wait_idle_s.enc": 1650e-6,
            "ckpt_write_idle_s.enc": 0.0, "ckpt_read_idle_s.dec": 0.0}
    for name in SPAN_METRICS:
        read = harness.metric_reader(name)
        assert read(t) == pytest.approx(want[name]), name
        # nothing to read: no trace, no call, or a program without spans
        assert read(dict(t, trace=None)) is None
        assert read(dict(t, calls=[])) is None
        assert read(_t(_events(spans=False))) is None
    assert span_idle.innermost("load: sqz.resident.pack") == \
        "sqz.resident.pack"
    assert span_idle.innermost("between calls: host code") == "host code"


def test_read_reader_takes_the_read_and_the_unpack():
    # two loads: the first gap's middle falls in the file's read, the
    # second's in the container's unpack; both are the load's read
    events = [_ev(trace.WINDOW, "user_annotation", 0, 10000),
              _ev("load_pytree", "user_annotation", 0, 5000),
              _ev("load_pytree", "user_annotation", 5000, 5000),
              _ev("sqz.checkpoint.read", "user_annotation", 0, 3000),
              _ev("sqz.resident.unpack", "user_annotation", 3000, 1000),
              _ev("k", "kernel", 4000, 1000, tid=7),
              _ev("sqz.checkpoint.read", "user_annotation", 5000, 1000),
              _ev("sqz.resident.unpack", "user_annotation", 6000, 3000),
              _ev("k", "kernel", 9000, 1000, tid=7)]
    t = dict(calls=[{}, {}],
             trace=trace.summarize(events, spans=("load_pytree",)))
    assert dict(t["trace"]["idle_gaps"]) == pytest.approx({
        "load_pytree: sqz.checkpoint.read": 4000e-6,
        "load_pytree: sqz.resident.unpack": 4000e-6})
    assert harness.metric_reader("ckpt_read_idle_s.dec")(t) == \
        pytest.approx(4000e-6)
    assert harness.metric_reader("ckpt_write_idle_s.enc")(t) == 0.0


def test_the_cell_runs_the_exact_parse_and_reports_its_metrics():
    cell, config, e2e, layer = harness.find_cell(harness.bench(), CELL)
    assert cell["chips"] == 1 and config["name"] == "text100m-sqz4"
    traffic = harness.load_traffic(cell["traffic"])
    assert traffic["entry"] == "compress_exact"
    assert traffic["kwargs"] == {"parse": "exact"}
    assert traffic["ref_strata"] == harness.load_traffic(
        "compress")["ref_strata"]
    assert {m["name"] for m in e2e} == {"enc_MBps", "ratio", "setup_s"}
    assert {m["name"] for m in layer} == {
        "pipeline_encoder_roofline.enc", "idle_share.enc",
        "plan_wait_idle_s.enc"}
    b = harness.bench()
    for name in SPAN_METRICS:
        (m,) = [m for m in b["per_layer"] if m["name"] == name]
        assert m["source"] == "program_span" and m["unit"] == "s"
        assert m["better"] == "lower"


def _blocks(blob, data, blk_bits, win_bits):
    expect = dict(fmt=1, win_bits=win_bits, blk_bits=blk_bits, flags=1,
                  size=len(data), checksum=ref_sqzt.fnv1a64_plain(data))
    _, payloads, bad = ref_sqzt.read(blob, expect)
    assert bad == 0
    bs = 1 << blk_bits
    return [(p, data[b * bs:(b + 1) * bs], 1 << win_bits)
            for b, p in enumerate(payloads)]


def test_exact_reference_gives_the_host_engines_bytes():
    import sqz_tpu_torch
    data = texty(2 * 65536 + 3000, seed=2 ** 33 + 5)
    exact = sqz_tpu_torch.compress(data, engine="native", blk_bits=16,
                                   win_bits=15, parse="exact")
    fast = sqz_tpu_torch.compress(data, engine="native", blk_bits=16,
                                  win_bits=15, parse="fast")
    jobs = _blocks(exact, data, 16, 15)
    assert [sqz4_exact.block_differs(j) for j in jobs] == [0, 0, 0]
    # the fast parse's full blocks are other bytes, and still decode
    jobs = _blocks(fast, data, 16, 15)
    assert [sqz4_exact.block_differs(j) for j in jobs[:2]] == [1, 1]
    assert not any(map(ref_sqz4.block_differs,
                       [(p, blk) for p, blk, _ in jobs]))


def test_exact_parse_by_hand():
    # "abcabcabc": a literal each for a, b, c, then one overlapping match
    assert sqz4_exact.exact_tokens(b"abcabcabc", 1 << 10) == [
        ("lit", 97), ("lit", 98), ("lit", 99), ("match", 6, 3)]
    # the nearer of two equally long matches; the window bounds the reach
    data = b"xyQQQQxyRRRRxy"
    assert sqz4_exact.longest_match(data, 12, 1 << 10) == (2, 6)
    assert sqz4_exact.longest_match(data, 12, 6) == (0, 0)
    # a short match whose distance takes more than 3 bits is a literal
    far = b"ab" + bytes(range(100, 110)) + b"ab"
    assert sqz4_exact.exact_tokens(far, 1 << 10)[-2:] == [("lit", 97),
                                                         ("lit", 98)]
    blk = texty(5000, seed=9)
    assert ref_sqz4.decode_block(sqz4_exact.encode_block(blk, 1 << 12),
                                 len(blk)) == blk


def test_exact_check_counts_blocks_of_another_parse():
    import sqz_tpu_torch
    data = texty(3 * 4096, seed=2 ** 33 + 9)
    kw = dict(blk_bits=12, win_bits=12)
    traffic = dict(ref_blocks=3)
    blobs = {p: sqz_tpu_torch.compress(data, engine="native", parse=p, **kw)
             for p in ("exact", "fast")}

    def differing(blob):
        return compress_exact.exact_blocks_differing(
            [blob], data, kw, traffic, random.Random(1))

    assert differing(blobs["exact"]) == 0
    assert differing(blobs["fast"]) >= 1
    assert differing(blobs["exact"][:-1]) == 3     # broken: every pick


def _small(tiny):
    """The text configuration at 3 blocks of 4 KiB, the least where the
    fast parse's hash chains miss matches that the exact parse takes."""
    cfg = tiny("text100m-sqz4")
    cfg["bytes"] = 3 * 4096
    cfg["codec"].update(blk_bits=12, win_bits=12)
    return cfg


def _small_run(tiny, find=None):
    return harness.run(CELL, 2 ** 33 + 11, 0.2, False, device="cpu",
                       cfg=_small(tiny), find=find)


def test_the_cell_is_correct_on_a_sound_run(tiny):
    r = _small_run(tiny)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"]["exact_blocks_differing"] == {"value": 0, "limit": 0}
    assert set(r["metrics"]) == {"enc_MBps", "ratio", "setup_s"}


def test_the_cells_control_fails_on_the_exact_parse(tiny):
    # the fast parse round-trips and fills a valid container: only the
    # exact parse's check sees it
    checks = {k: c["value"] for k, c in _small_run(
        tiny, control.control)["checks"].items()}
    assert checks.pop("exact_blocks_differing") >= 1
    assert not any(checks.values()), checks


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_the_cell_is_not_correct_for_its_faults(tiny, fault):
    assert not _small_run(tiny, control.faulty(fault))["correct"]
