"""Check the device LZ matcher on the card (the port of the reference's
``tools/check_lz.py``) on pseudo-text uploaded once as a tensor:

- every block of the resident encode in mode "lz" must round-trip through
  the native decoder;
- its ratio may trail the native fast parse's on the same blocks by at
  most MAX_GAP_PP percentage points (the reference's bar);
- the general restore (``decompress_resident(assembly="general")``) must
  restore the input with no bad lane (none on the host route).

    python -m sqz_tpu_torch.tools.check_lz [--bytes N] [--blk-bits B]
        [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import torch

from sqz_tpu_torch import native
from sqz_tpu_torch.formats import container as sqzt
from sqz_tpu_torch.formats.constants import SQZT_FORMAT_SQZ4
from sqz_tpu_torch.ops import resident
from sqz_tpu_torch.ops.launch import resolve_device
from sqz_tpu_torch.tools import CheckFailed, parser, run, timed
from sqz_tpu_torch.utils import corpus

WINDOW = 1 << 15
MAX_GAP_PP = 1.6   # tools/check_lz.py:68


def check(args) -> dict:
    dev = resolve_device(args.device)
    bb = args.blk_bits
    bs = 1 << bb
    data = corpus.texty(args.bytes, seed=1)
    parts = [data[o:o + bs] for o in range(0, len(data), bs)]
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    print(f"input {len(data)} B, {len(parts)} blocks of 2^{bb}", flush=True)
    payloads, t_lz = timed(lambda: resident.encode_resident_blocks(
        x, bb, "lz", device=dev), dev)
    for b, (p, part) in enumerate(zip(payloads, parts)):
        if native.sqz4_decompress_payload(p, len(part)) != part:
            raise CheckFailed(f"device-LZ block {b} does not round-trip "
                              f"through the native decoder")
    fast, t_fast = timed(lambda: [native.sqz4_compress_payload(
        p, WINDOW, lz=True, parse="fast") for p in parts], dev)
    r_lz = sum(map(len, payloads)) / len(data)
    r_fast = sum(map(len, fast)) / len(data)
    gap = (r_lz - r_fast) * 100
    mb = len(data) / 1e6
    print(f"device LZ on {dev}: {mb / t_lz:.1f} MB/s incl. transfers, "
          f"ratio {r_lz * 100:.2f}%; host fast parse {mb / t_fast:.1f} "
          f"MB/s, ratio {r_fast * 100:.2f}%: gap {gap:+.2f} pp", flush=True)
    if gap > MAX_GAP_PP:
        raise CheckFailed(f"ratio gap {gap:.2f} pp exceeds the "
                          f"{MAX_GAP_PP} pp bar")
    blob = sqzt.pack(SQZT_FORMAT_SQZ4, 15, bb, len(data), payloads, None)
    before = dict(resident.route_lanes)
    out, t_dec = timed(lambda: resident.decompress_resident(
        blob, assembly="general", device=dev), dev)
    routes = {k: resident.route_lanes[k] - before[k] for k in before}
    if out.cpu().numpy().tobytes() != data:
        raise CheckFailed("the general restore differs from the input")
    if routes["host"]:
        raise CheckFailed(f"the general restore has bad lanes: {routes}")
    print(f"OK: the general restore on {dev}: {mb / t_dec:.1f} MB/s, "
          f"routes {routes}", flush=True)
    return {"lz_MBps": mb / t_lz, "lz_ratio": r_lz, "lz_fast_ratio": r_fast,
            "lz_gap_pp": gap, "lz_general_dec_MBps": mb / t_dec}


def main(argv=None, report: dict = None) -> int:
    return run(check, parser(__doc__, 32 << 20, 16).parse_args(argv), report)


if __name__ == "__main__":
    sys.exit(main())
