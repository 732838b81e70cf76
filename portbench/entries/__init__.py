"""The program's entries as the traffic mixes drive them, one module
each, found by the name a traffic file gives as its ``entry``: the
module ``portbench.entries.<entry>`` holds ``Entry`` (set-up, the timed
call, the check of what the calls produced) and ``Control`` (the step
that would tempt a later change, in the call's place: it has to come
out not correct). What the entries share is in ``common``."""

from __future__ import annotations

import importlib


def find(name: str, kind: str = "Entry"):
    """The class ``kind`` of the entry module ``name``."""
    return getattr(importlib.import_module(f"portbench.entries.{name}"),
                   kind)
