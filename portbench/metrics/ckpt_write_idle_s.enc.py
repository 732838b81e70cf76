"""ckpt_write_idle_s.enc: seconds a save leaves the card idle while the
host packs the container, pickles the metadata and writes the file
(``utils/checkpoint.py`` ``save_pytree``, the span
``sqz.checkpoint.write``)."""

from portbench.span_idle import idle_per_call

SPANS = ("sqz.checkpoint.write",)


def read(t):
    return idle_per_call(t, SPANS)
