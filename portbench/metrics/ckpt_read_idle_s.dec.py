"""ckpt_read_idle_s.dec: seconds a load leaves the card idle while the
host reads the file, its metadata and the container
(``utils/checkpoint.py`` ``read_checkpoint``, the span
``sqz.checkpoint.read``) and then unpacks the container's header and
payloads (``ops/resident.py`` ``unpack_cold_container``, the span
``sqz.resident.unpack``). The two run back to back with no device work
between them, so they make one idle gap, which ``trace.py`` gives whole
to the one over its middle: the reader takes both."""

from portbench.span_idle import idle_per_call

SPANS = ("sqz.checkpoint.read", "sqz.resident.unpack")


def read(t):
    return idle_per_call(t, SPANS)
