"""A run's result line, its refusal without a card, the traced window's
reading, and the check's controls and faults, on the CPU through the
program's plain versions at tiny sizes (the harness's look for a chip
skipped)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import control, faults, harness, readers, trace
from portbench.entries import common, decompress
from portbench.reference import sqzt as ref_sqzt

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("gpt2s-adamw-ckpt.load", "gpt2s-adamw-ckpt.save",
         "text100m-sqz4.compress", "text100m-sqz4.decompress")
REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}


def _tiny_run(tiny, cell, find=None, seed=2 ** 33 + 3):
    return harness.run(cell, seed, 0.2, False, device="cpu",
                       cfg=tiny(cell.split(".")[0]), find=find)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    r = _tiny_run(tiny, cell)
    assert set(r) == REQUIRED | {"settings", "checks"}
    assert list(r)[-1] == "checks"
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c == {"value": 0, "limit": 0} for c in r["checks"].values())
    _, _, e2e, _ = harness.find_cell(harness.bench(), cell)
    assert set(r["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    r = _tiny_run(tiny, cell, find=control.control)
    assert not r["correct"]


def test_decompress_control_fails_on_the_corrupt_copies(tiny):
    # the timed decode without its checksum's verification gives the
    # input back; only the corrupt copies show what it lost
    r = _tiny_run(tiny, "text100m-sqz4.decompress", find=control.control)
    checks = {k: c["value"] for k, c in r["checks"].items()}
    assert checks.pop("corrupt_checksum_accepted") == 1
    checks.pop("corrupt_payload_accepted")
    assert not any(checks.values()), checks


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny, cell, fault):
    r = _tiny_run(tiny, cell, find=control.faulty(fault))
    assert not r["correct"], r["checks"]


def test_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_switches_unset(monkeypatch):
    monkeypatch.setenv("SQZ_PARSE", "exact")
    monkeypatch.setenv("SQZ_PIPELINE", "0")
    assert harness.unset_switches() == ["SQZ_PARSE", "SQZ_PIPELINE"]
    assert "SQZ_PARSE" not in os.environ


def test_harness_loads_no_jax():
    code = ("import sys, portbench.run, portbench.harness, "
            "portbench.control; from portbench.harness import "
            "metric_reader, bench, load_traffic; from portbench import "
            "entries\n"
            "b = bench()\n"
            "for m in b['end_to_end'] + b['per_layer']: "
            "metric_reader(m['name'])\n"
            "for w in b['workloads']: "
            "entries.find(load_traffic(w['traffic'])['entry'])\n"
            "import sqz_tpu_torch, sqz_tpu_torch.utils.checkpoint\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert not set(out.split()) & {"jax", "jaxlib", "flax", "sqz_tpu"}


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def test_trace_summary_by_hand():
    events = [
        _ev(trace.WINDOW, "user_annotation", 0, 1000),
        _ev("compress", "user_annotation", 0, 600),
        _ev("cudaStreamSynchronize", "cuda_runtime", 100, 300),
        _ev("void sqz4_decode_kernel<false>(unsigned int const*)", "kernel",
            150, 200, tid=7),
        _ev("Memcpy HtoD", "gpu_memcpy", 300, 100, tid=7),   # overlaps
        _ev("void sqz4_cell_kernel(int)", "kernel", 900, 200, tid=7),
    ]
    s = trace.summarize(events, spans=("compress",))
    assert s["window_s"] == pytest.approx(1000e-6)
    # device busy: [150, 400) and [900, 1000), clipped to the window
    assert s["busy_s"] == pytest.approx(350e-6)
    assert s["kernels"] == pytest.approx({"sqz4_decode_kernel<false>": 200e-6,
                                          "sqz4_cell_kernel": 100e-6})
    gaps = dict(s["idle_gaps"])
    # [0, 150) mid 75: no host call; [400, 900): mid 650, after the call
    assert gaps["compress: host code"] == pytest.approx(150e-6)
    assert gaps["between calls: host code"] == pytest.approx(500e-6)
    assert trace.kernel_name(
        "void at::native::k<4, at::native::(anonymous namespace)::F>"
        "(int, char*)") == "at::native::k<4, at::native::(anonymous " \
        "namespace)::F>"


def test_roofline_bytes_by_hand():
    kind = "NVIDIA H100 80GB HBM3"
    t = dict(calls=[{"start": 0, "end": 1, "stats": {"pack_s": 0.25}}] * 4,
             sizes=dict(raw=65536, payload=1000),
             trace=dict(kernels={"sqz4_decode_kernel<false>": 2e-3,
                                 "sqz4_encode_tok_kernel<true>": 1e-3},
                        busy_s=0.5, window_s=2.0),
             peaks={kind: {"hbm_bytes_per_s": 3.35e12}}, kind=kind)
    # 4 calls x (65536 + 1000) B at 3.35e12 B/s over 2 ms
    want = 100 * 4 * 66536 / 3.35e12 / 2e-3
    read = harness.metric_reader("decoder_roofline.dec")
    assert read(t) == pytest.approx(want)
    assert harness.metric_reader("lit_skip_roofline.enc")(t) == \
        pytest.approx(want * 2)
    assert harness.metric_reader("pipeline_encoder_roofline.enc")(t) is None
    assert harness.metric_reader("idle_share.dec")(t) == pytest.approx(75.0)
    assert harness.metric_reader("resident_pack_s.dec")(t) == 0.25
    assert harness.metric_reader("checkpoint_self_s.dec")(t) == 0.75
    assert readers.share(dict(t, kind="cpu"), "sqz4") is None
    assert readers.share(dict(t, sizes=None), "sqz4") is None


def test_end_to_end_readers_by_hand():
    calls = [dict(start=0.5, end=2.0, in_bytes=3_000_000, stored=600_000),
             dict(start=2.0, end=4.0, in_bytes=3_000_000, stored=900_000)]
    t = dict(calls=calls, setup_s=7.5)
    # 6 MB from the window's start to the end of the last call, 4 s
    assert harness.metric_reader("enc_MBps")(t) == pytest.approx(1.5)
    assert harness.metric_reader("dec_MBps")(t) == pytest.approx(1.5)
    assert harness.metric_reader("ratio")(t) == pytest.approx(0.25)
    assert harness.metric_reader("setup_s")(t) == 7.5
    t = dict(calls=[dict(c, stored=0) for c in calls], setup_s=1.0)
    assert harness.metric_reader("ratio")(t) is None
    assert harness.metric_reader("enc_MBps")(dict(calls=[])) is None


def test_block_picks_cover_every_group_and_launch():
    import random
    # 22,786 blocks: 45 groups of 512, launches of 3 groups
    picks = common.block_picks([22_786, 22_786], dict(lanes=512, groups=3),
                               8, random.Random(5))
    blocks = {b for _, b in picks}
    assert {b // 512 for b in blocks} == set(range(45))
    lasts = {min((k + 1) * 1536, 22_786) - 1 for k in range(15)}
    assert lasts <= blocks and 22_785 in blocks
    assert len(picks) <= 45 + 15 + 1
    # without strata: the last block, then random ones up to the count
    picks = common.block_picks([1526, 1526], {}, 24, random.Random(5))
    assert len(picks) == 24 and (0, 1525) in picks
    assert len(common.block_picks([3], {}, 24, random.Random(5))) == 3


def test_decompress_copies_by_hand():
    import random
    import sqz_tpu_torch
    from portbench.inputs.texty import texty
    data = texty(3000, seed=4)
    blob = sqz_tpu_torch.compress(data, blk_bits=10, win_bits=10,
                                  device="cpu")
    expect = dict(fmt=1, win_bits=10, blk_bits=10, flags=1, size=3000,
                  checksum=ref_sqzt.fnv1a64_plain(data))
    _, payloads, bad = ref_sqzt.read(blob, expect)
    assert bad == 0
    payload, checksum = decompress.corrupted(blob, random.Random(1))
    at = decompress.checksum_at(blob)
    diff = [i for i in range(len(blob)) if payload[i] != blob[i]]
    assert len(diff) == 1 and diff[0] >= at + 8
    diff = [i for i in range(len(blob)) if checksum[i] != blob[i]]
    assert len(diff) == 1 and at <= diff[0] < at + 8
    bare = decompress.without_checksum(blob)
    got, p, bad = ref_sqzt.read(bare, dict(expect, flags=0))
    assert bad == 0 and p == payloads and "checksum" not in got
    assert sqz_tpu_torch.decompress(bare, device="cpu") == data
    with pytest.raises(ValueError):
        sqz_tpu_torch.decompress(checksum, device="cpu")


@pytest.mark.gpu
def test_cell_on_the_card_from_a_bare_checkout(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cmd = [sys.executable, "-m", "portbench.run", "--workload",
           "text100m-sqz4.decompress", "--seed", "5", "--seconds", "2",
           "--trace", "0"]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
    # a directory with only BENCHMARK.json and the benchmark: no program
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    p = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode != 0 and p.stdout.strip() == ""
