"""The wide-block compress cell (``text100m-sqz4-blk20.compress-wide``):
its configuration, traffic, entry, control and metrics found by name,
its two readers on a synthetic trace, and its run on the CPU through the
program's plain versions at one small block above 64 KiB."""

import pytest

from portbench import control, faults, harness, trace
from portbench.entries import compress_exact, compress_wide

CELL = "text100m-sqz4-blk20.compress-wide"


def test_the_cell_is_found_by_name():
    from sqz_tpu_torch.ops import sqz4_host
    cell, config, e2e, layer = harness.find_cell(harness.bench(), CELL)
    assert cell["chips"] == 1 and config["name"] == "text100m-sqz4-blk20"
    cfg = harness.load_config(config)
    codec = dict(harness.load_config(dict(
        file="portbench/configs/text100m-sqz4.json"))["codec"], blk_bits=20)
    assert cfg["codec"] == codec and cfg["bytes"] == 10 ** 8
    bs = 1 << 20
    nb = -(-cfg["bytes"] // bs)
    assert (nb, cfg["bytes"] - (nb - 1) * bs) == (96, 385_280)
    traffic = harness.load_traffic(cell["traffic"])
    assert traffic["entry"] == "compress_wide" and "kwargs" not in traffic
    assert traffic["ref_blocks"] == 16
    assert traffic["ref_strata"]["lanes"] == sqz4_host.group_lanes(nb)
    assert traffic["ref_strata"]["groups"] == 1
    assert compress_wide.Entry is compress_exact.Entry
    assert {m["name"] for m in e2e} == {"enc_MBps", "ratio", "setup_s"}
    assert {m["name"] for m in layer} == {
        "stats_encoder_roofline.enc", "idle_share.enc",
        "wide_stats_idle_s.enc"}


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _t():
    """Two compress calls in a window of 10 ms: the wide route's plan and
    model spans, the pipeline's and the serial encoder's other spans, and
    the card's kernels of every encoder between them."""
    host = [("sqz.encode.plan", 0, 2000), ("sqz.encode.model", 2000, 1000),
            ("sqz.encode.upload", 3000, 500),
            ("sqz.pipeline.wait_plan", 4000, 1000),
            ("sqz.encode.model", 5500, 1500),
            ("sqz.pipeline.plan", 7500, 1000)]
    kernels = [("sqz4_encode_stats_kernel", 3500, 500),
               ("sqz4_encode_kernel<false>", 5000, 500),
               ("sqz4_encode_tok_kernel<false>", 7000, 500),
               ("sqz4_encode_stats_kernel", 8500, 1000)]
    events = [_ev(trace.WINDOW, "user_annotation", 0, 10000),
              _ev("compress", "user_annotation", 0, 5000),
              _ev("compress", "user_annotation", 5000, 5000)]
    events += [_ev(n, "user_annotation", s, d) for n, s, d in host]
    events += [_ev(n, "kernel", s, d, tid=7) for n, s, d in kernels]
    s = trace.summarize(events, spans=("compress",))
    return dict(calls=[{}, {}], trace=s, sizes=dict(raw=600, payload=400),
                peaks={"card": {"hbm_bytes_per_s": 1e9}}, kind="card")


def test_the_readers_read_their_own_kernel_and_spans():
    t = _t()
    assert dict(t["trace"]["idle_gaps"]) == pytest.approx({
        "compress: sqz.encode.plan": 3500e-6,
        "compress: sqz.pipeline.wait_plan": 1000e-6,
        "compress: sqz.encode.model": 1500e-6,
        "compress: sqz.pipeline.plan": 1000e-6,
        "compress: host code": 500e-6})
    # the two stats-fed launches alone: 2 calls of 1000 bytes at 1e9 B/s
    # over their 1.5 ms
    roof = harness.metric_reader("stats_encoder_roofline.enc")
    assert roof(t) == pytest.approx(100.0 * 2 * 1000 / 1e9 / 1500e-6)
    # the plan's and the model's gaps, a call; not the pipeline's
    idle = harness.metric_reader("wide_stats_idle_s.enc")
    assert idle(t) == pytest.approx((3500e-6 + 1500e-6) / 2)
    # nothing to read: no trace, no stats-fed launch, no span
    assert roof(dict(t, trace=None)) is None
    assert idle(dict(t, trace=None)) is None
    quiet = dict(t["trace"], kernels={"sqz4_encode_kernel<false>": 1.0},
                 idle_gaps=[["compress: host code", 1.0]])
    assert roof(dict(t, trace=quiet)) is None
    assert idle(dict(t, trace=quiet)) is None
    # a program that times the statistics as one stage
    older = dict(t["trace"], idle_gaps=[["compress: sqz.encode.stats", 1.0],
                                        ["compress: sqz.encode.fetch", 0.1]])
    assert idle(dict(t, trace=older)) is None


def _small(tiny):
    """The cell's configuration at one block of 3,000 B above 64 KiB
    (``blk_bits`` 17), where the fast parse's hash chains miss matches
    that the exact parse takes (``win_bits`` 12)."""
    cfg = tiny("text100m-sqz4-blk20")
    cfg["bytes"] = 3000
    cfg["codec"].update(blk_bits=17, win_bits=12)
    return cfg


def _small_run(tiny, find=None):
    return harness.run(CELL, 2 ** 33 + 11, 0.2, False, device="cpu",
                       cfg=_small(tiny), find=find)


def test_the_cell_is_correct_on_a_sound_run(tiny):
    from sqz_tpu_torch.ops import engine
    before = engine.wide_blocks
    r = _small_run(tiny)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"]["exact_blocks_differing"] == {"value": 0, "limit": 0}
    assert set(r["metrics"]) == {"enc_MBps", "ratio", "setup_s"}
    # the set-up's call and the window's each took the wide route
    assert engine.wide_blocks >= before + 1 + r["attempted"]


def test_the_cells_control_fails_on_the_exact_parse(tiny):
    # the native engine's fast parse round-trips and fills a valid
    # container: only the exact parse's check sees it
    checks = {k: c["value"] for k, c in _small_run(
        tiny, control.control)["checks"].items()}
    assert checks.pop("exact_blocks_differing") >= 1
    assert not any(checks.values()), checks


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_the_cell_is_not_correct_for_its_faults(tiny, fault):
    assert not _small_run(tiny, control.faulty(fault))["correct"]
