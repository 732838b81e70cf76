"""What a ``torch.profiler`` trace of the measured window says: device
time by kernel, the union of device activity, and the idle gaps with
what the host was doing in them.

Read from the Chrome trace that ``export_chrome_trace`` writes: device
work is every event of category ``kernel``, ``gpu_memcpy`` or
``gpu_memset``; the window and each call are ``user_annotation`` spans
that the harness opens (``WINDOW`` and the entry's name); what the host
was doing is the innermost host event on the window's thread, or "host
code" where no torch operation or CUDA call was open (Python, or the
program's native code).
"""

from __future__ import annotations

import bisect
import json

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


def kernel_name(name: str) -> str:
    """A device event's name without its argument list: cut at the first
    parenthesis outside template brackets."""
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name.removeprefix("void ").strip()


def merge(intervals):
    """Sorted, disjoint (start, end) from any (start, end)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, spans=()) -> dict:
    """Chrome-trace events -> ``window_s``, ``busy_s``, ``kernels``
    ({kernel name: device seconds in the window}), ``device_ops`` and
    ``idle_gaps`` (each the ``TOP`` largest, as [name, seconds]); None
    when the trace holds no window span. ``spans`` names the
    ``user_annotation`` spans of the calls."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w = win[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    tid = (w.get("pid"), w.get("tid"))
    dev, kernels, host, calls = [], {}, [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        lo, hi = max(s, w0), min(s + d, w1)
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            if hi > lo:
                dev.append((lo, hi))
                if cat == "kernel":
                    k = kernel_name(e["name"])
                    kernels[k] = kernels.get(k, 0.0) + (hi - lo) / 1e6
        elif (e.get("pid"), e.get("tid")) == tid and cat in HOST_CATS \
                and e is not w:
            if e.get("name") in spans:
                calls.append((s, s + d, e["name"]))
            else:
                host.append((s, s + d, e["name"]))
    busy = merge(dev)
    gaps, at = [], w0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < w1:
        gaps.append((at, w1))
    host.sort()
    calls.sort()
    starts = [h[0] for h in host]
    call_starts = [c[0] for c in calls]
    by_label: dict = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        i = bisect.bisect_right(call_starts, mid) - 1
        span = calls[i][2] if i >= 0 and calls[i][1] > mid \
            else "between calls"
        top = None
        # the innermost host event over mid: the latest start that
        # covers it (a few steps back past events that ended before)
        for j in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 1 - 256),
                       -1):
            if host[j][1] > mid:
                top = host[j][2]
                break
        label = f"{span}: {top or 'host code'}"
        by_label[label] = by_label.get(label, 0.0) + (g1 - g0) / 1e6
    busy_s = sum(e - s for s, e in busy) / 1e6
    return dict(window_s=(w1 - w0) / 1e6, busy_s=busy_s, kernels=kernels,
                device_ops=sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP],
                idle_gaps=sorted(by_label.items(),
                                 key=lambda kv: -kv[1])[:TOP])


def read(path, spans=()) -> dict:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return summarize(events, spans)
