"""wide_stats_idle_s.enc: seconds a compress call above 64 KiB blocks
leaves the card idle while the host computes the stats-fed encoder's
input (``ops/sqz4_cuda.py`` ``encode_data_stats``): the exact tokens
(``sqz4_host.exact_op_streams``, ``native.sqz4_plan_pack``, the span
``sqz.encode.plan``) and the per-op model statistics
(``sqz4_host.op_stats``, one ``native.sqz4_model_stats`` call a block,
the span ``sqz.encode.model``).

The two run back to back with no device work between them, in the one
long idle gap of a call that also holds the container's host work
around them (the previous call's checksum and pack, this call's split
and join) and the host half of the statistics' upload (``np.stack``):
at 10^8 B, 6.42 s under the two labels against 5.74 s inside the two
spans on an H100's host. ``trace.py`` gives that gap whole to the span over
its middle, which falls in one or the other of the two: the reader takes
both. None where no kept label names either: a program that times the
two as one stage (``sqz.encode.stats``) or runs no such route."""

from portbench.span_idle import idle_per_call, innermost

SPANS = ("sqz.encode.plan", "sqz.encode.model")


def read(t):
    tr = t.get("trace")
    if tr is None or not any(innermost(label) in SPANS
                             for label, _ in tr["idle_gaps"]):
        return None
    return idle_per_call(t, SPANS)
