"""The arithmetic the metrics' readers (``metrics/<name>.py``) share.

End to end, from the window's calls: a rate in MB/s and the ratio of
bytes stored. Per layer, from the traced window: the ``stats=`` stages,
the idle share, and a kernel's share of its roofline, bounded by bytes:
the least time the card could take to read the call's input bytes once
and write its output bytes once at the card's memory bandwidth
(``peaks.json``), over the kernel's device time in the traced window. A
coder's steps depend on how it is written and its bytes do not, so no
operation count enters. The bytes come from the cell's own sizes
(``entry.sizes``), never from the kernel."""

from __future__ import annotations

import re


def rate_mb_s(t: dict):
    """MB (10^6 B) of the window's calls' input over the time from the
    window's start to the end of the last call; None without a call."""
    if not t["calls"]:
        return None
    return sum(c["in_bytes"] for c in t["calls"]) / 1e6 / t["calls"][-1]["end"]


def stored_ratio(t: dict):
    """Bytes stored over input bytes, summed over the window's calls;
    None where the calls store nothing."""
    stored = sum(c["stored"] for c in t["calls"])
    if not stored:
        return None
    return stored / sum(c["in_bytes"] for c in t["calls"])


def device_seconds(t: dict, pattern: str) -> float:
    """Device seconds in the traced window of the kernels whose name
    matches ``pattern``."""
    if t["trace"] is None:
        return 0.0
    return sum(s for k, s in t["trace"]["kernels"].items()
               if re.search(pattern, k))


def share(t: dict, pattern: str, keys=("raw", "payload")):
    """Percent of the roofline, a call's bytes the sum of the sizes
    ``keys``; None where the kernel did not run, the run has no sizes or
    the card has no entry in the table of peaks."""
    secs = device_seconds(t, pattern)
    peak = t["peaks"].get(t["kind"], {}).get("hbm_bytes_per_s")
    if secs <= 0 or not peak or not t["sizes"]:
        return None
    per_call = sum(t["sizes"][k] for k in keys)
    return 100.0 * len(t["calls"]) * per_call / peak / secs


def mean_stage(t: dict, key: str):
    """The mean over the traced calls of one ``stats=`` stage."""
    vals = [c["stats"].get(key, 0.0) for c in t["calls"] if c["stats"]]
    return sum(vals) / len(vals) if vals else None


def mean_self(t: dict):
    """The mean over the traced calls of the call's wall time less the
    stages its ``stats=`` dict accounts for."""
    vals = [c["end"] - c["start"] - sum(c["stats"].values())
            for c in t["calls"] if c["stats"]]
    return sum(vals) / len(vals) if vals else None


def idle_share(t: dict):
    tr = t["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
