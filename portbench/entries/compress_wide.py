"""``compress(data)`` at blocks above 64 KiB (``blk_bits`` 17..40): the
program's route there (``ops/engine.py`` ``_sqz4_wide``: exact tokens
and per-op statistics on the host, the stats-fed encoder on the card)
codes the exact parse whatever ``parse`` asks for, so its check is the
exact-parse compress's: the containers' fields and checksum, the
traffic's blocks through the plain decoder and, each, against the plain
exact-parse encoder (``portbench.reference.sqz4_exact``), and the
program's decompress of every kept container."""

from __future__ import annotations

from portbench.entries import compress_exact


Entry = compress_exact.Entry


class Control(Entry):
    """Each block coded by the native engine's fast parse on the host:
    the step a faster, non-exact planner would take. Its container is
    valid, checksummed and round-trips; only the exact parse's check
    sees it."""

    def call(self, stats):
        return self.sqz.compress(self.data, **dict(self.kw, engine="native",
                                                   parse="fast"))
