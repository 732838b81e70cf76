"""One run of one cell: set-up, the measured window, the metrics, and
the check.

Everything that belongs to a configuration, a traffic mix or a metric
sits in a file of its own under this folder, found by the name
``BENCHMARK.json`` gives it: ``configs/<config>.json`` (the deployment and
the input generator it names under ``inputs/``), ``traffic/<mix>.json``
(the entry module under ``entries/`` and its parameters) and
``metrics/<metric>.py`` for every metric, end to end and per layer (a
``read(t)`` that returns the metric, or None where the run has nothing
to read).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from portbench import entries, trace
from portbench.entries.common import sync

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "sqz_tpu")


class NoDevice(RuntimeError):
    """The cell's chips are not there: the run prints no result."""


@dataclass
class Context:
    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    device: str = "cuda"
    inputs: object = None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def bench() -> dict:
    return load_json(BENCHMARK)


def find_cell(b: dict, name: str):
    """(the workload, its configuration entry, its end-to-end metrics, its
    per-layer metrics) from ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in b["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = next(c for c in b["configs"] if c["name"] == cell["config"])
    e2e = [m for m in b["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in b["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported
                              else [])]
    return cell, config, e2e, layer


def load_config(config: dict) -> dict:
    return load_json(HERE.parent / config["file"])


def load_traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def make_inputs(cfg: dict, seed: int, device):
    """The configuration's inputs from ``seed``, by the generator its
    ``input`` names (a module under ``inputs/`` with ``make``)."""
    mod = importlib.import_module(f"portbench.inputs.{cfg['input']}")
    return mod.make(cfg, seed, device)


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def unset_switches() -> list:
    """Unset the program's ``SQZ_*`` switches so that every cell runs the
    default path; returns their names."""
    names = sorted(k for k in os.environ if k.startswith("SQZ_"))
    for k in names:
        del os.environ[k]
    return names


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def window(entry, seconds: float, keep, traced: bool):
    """Calls back to back until ``seconds`` have passed since the first
    began (at least one); a traced window gives each call a span and the
    program's ``stats=`` dict. Returns (the calls' (start, end, in bytes,
    stored bytes, stats) from the window's start, failed calls)."""
    calls, failed = [], 0
    name = entry.ctx.traffic["entry"]
    t0 = time.perf_counter()
    while not calls or time.perf_counter() - t0 < seconds:
        st = {} if traced and entry.takes_stats else None
        t = time.perf_counter()
        try:
            if traced:
                with torch.profiler.record_function(name):
                    out = entry.call(st)
            else:
                out = entry.call(st)
        except (ValueError, OSError, RuntimeError) as e:
            failed += 1
            print(f"call failed: {e!r}", file=sys.stderr)
            if failed >= 3:
                break
            continue
        end = time.perf_counter()
        calls.append(dict(start=t - t0, end=end - t0,
                          in_bytes=entry.in_bytes(out),
                          stored=entry.stored_bytes(out), stats=st))
        keep.add(out)
    return calls, failed


def read_metrics(specs, t: dict) -> dict:
    """Each metric of ``specs`` that its reader finds in ``t``."""
    out = {}
    for m in specs:
        v = metric_reader(m["name"])(t)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run(cell_name: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t_start: float = None, cfg: dict = None,
        find=None) -> dict:
    """One run of ``cell_name``; returns the result line as a dict, with
    ``checks`` last. ``cfg`` replaces the configuration's file (tests use
    small ones); ``find`` replaces ``entries.find`` (the controls' and
    the faults')."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell, config, e2e, layer = find_cell(bench(), cell_name)
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"{cell_name} needs {cell['chips']} CUDA "
                           f"device(s); torch sees "
                           f"{torch.cuda.device_count()}")
    unset = unset_switches()
    cfg = cfg or load_config(config)
    traffic = load_traffic(cell["traffic"])
    ctx = Context(cell, cfg, traffic, seed, device)
    parts = {"start_s": time.perf_counter() - t_start}
    ctx.inputs = make_inputs(cfg, seed, device)
    sync(device)
    parts["inputs_s"] = time.perf_counter() - t_start - parts["start_s"]
    entry = (find or entries.find)(traffic["entry"])(ctx)
    try:
        return _run(ctx, entry, e2e, layer, seconds, traced, t_start, unset,
                    parts)
    finally:
        entry.close()


def _run(ctx, entry, e2e, layer, seconds, traced, t_start, unset, parts):
    device = ctx.device
    entry.setup()
    sync(device)
    setup_s = time.perf_counter() - t_start
    # the set-up's parts: imports and the device's start, the inputs, and
    # the entry's own (what its calls need, one warm call)
    parts["entry_s"] = setup_s - parts["start_s"] - parts["inputs_s"]
    keep = entry.keep()
    tr = None
    if traced and torch.device(device).type == "cuda":
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                calls, failed = window(entry, seconds, keep, True)
        fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            tr = trace.read(path, spans=(ctx.traffic["entry"],))
        finally:
            os.unlink(path)
    else:
        calls, failed = window(entry, seconds, keep, False)
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else 0
    outputs = keep.outputs()
    if not traced:
        metrics = read_metrics(e2e, dict(calls=calls, setup_s=setup_s))
    else:
        metrics = read_metrics(layer, dict(
            calls=calls, sizes=entry.sizes(outputs) if outputs else None,
            trace=tr, peaks=load_json(HERE / "peaks.json"),
            kind=device_kind(device)))
    # the check: after the window, with the program's other outputs freed
    t_check = time.perf_counter()
    checks = {"calls_failed": failed}
    checks.update(entry.check(outputs))
    keep.clear()
    del outputs
    check_s = time.perf_counter() - t_check
    result = {
        "correct": all(v == 0 for v in checks.values()),
        "attempted": len(calls) + failed,
        "failed": failed,
        "metrics": metrics,
        "device": dict(platform="gpu" if device == "cuda" else "cpu",
                       kind=device_kind(device), count=ctx.cell["chips"],
                       memory_peak_bytes=peak),
        "settings": dict(seed=ctx.seed, seconds=seconds, calls=len(calls),
                         unset_switches=unset, setup_parts=parts,
                         check_s=check_s,
                         calls_s=[round(c["end"] - c["start"], 6)
                                  for c in calls],
                         median_call_s=statistics.median(
                             c["end"] - c["start"] for c in calls)
                         if calls else None),
    }
    if tr is not None:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = dict(
            device_ops=[list(kv) for kv in tr["device_ops"]],
            idle_gaps=[list(kv) for kv in tr["idle_gaps"]])
    result["checks"] = {k: {"value": v, "limit": 0}
                        for k, v in checks.items()}
    return result


def device_kind(device) -> str:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(0)
    return "cpu"
