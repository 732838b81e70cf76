"""The card's idle seconds a call under the program's own spans.

The program opens a profiler range ``sqz.<layer>.<stage>`` around each
host stage of its calls (``sqz_tpu_torch/ops/launch.py``, ``Stages``),
and ``trace.summarize`` labels each idle gap of the traced window
"<call>: <the innermost host event open over it>". A gap inside a stage
where no torch operation or CUDA call is open carries the stage's name
last, so the seconds under a stage are the card's idle time that the
stage's host work held it back."""

from __future__ import annotations

PREFIX = "sqz."


def innermost(label: str) -> str:
    """The host event of an idle-gap label, without the call's name."""
    return label.rsplit(": ", 1)[-1]


def idle_per_call(t: dict, spans):
    """The idle seconds of the traced window whose label's innermost part
    is one of ``spans``, over the window's calls. Only the ``TOP``
    largest labels are kept (``trace.py``), so a stage absent from them
    reads 0. None without a trace or a call, and where no kept label
    names a span of the program: a program that opens none."""
    tr = t.get("trace")
    if tr is None or not t["calls"]:
        return None
    inner = [(innermost(label), s) for label, s in tr["idle_gaps"]]
    if not any(name.startswith(PREFIX) for name, _ in inner):
        return None
    return sum(s for name, s in inner if name in spans) / len(t["calls"])
