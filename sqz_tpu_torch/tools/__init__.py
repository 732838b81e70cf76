"""On-card checks of the port's kernels against the native engine (the
ports of the reference's ``tools/check_pallas_dec.py``,
``check_pallas_enc.py``, ``check_resident.py`` and ``check_lz.py``).

Each is a module with ``main(argv=None, report=None) -> int``, run as
``python -m sqz_tpu_torch.tools.<name>``: it drives its path on
``--device`` (default ``cuda``; ``cpu`` runs the plain versions, slowly:
keep ``--bytes`` to a few KiB), prints what it found and exits non-zero
on a failed check. ``report`` (a dict) receives the figures it printed.
Inputs are made from seeds (``utils.corpus.texty(seed=1)``,
``utils.synthetic.resident_mix(seed=1)``); sizes default to the
reference tools' own.
"""

from __future__ import annotations

import argparse
import time

import torch


class CheckFailed(Exception):
    """A check of a tool failed (the message says which)."""


def parser(doc: str, n_bytes: int, blk_bits: int) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--bytes", type=int, default=n_bytes,
                    help=f"input size (default {n_bytes})")
    ap.add_argument("--blk-bits", type=int, default=blk_bits,
                    help=f"log2 block size (default {blk_bits})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (the plain "
                         "versions)")
    return ap


def run(check, args, report) -> int:
    """``check(args)`` -> its figures into ``report``; 1 on CheckFailed."""
    try:
        figures = check(args)
    except CheckFailed as e:
        print(f"FAILED: {e}", flush=True)
        return 1
    if report is not None:
        report.update(figures)
    return 0


def timed(fn, dev):
    """(fn(), seconds), the device's work included."""
    t = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t
