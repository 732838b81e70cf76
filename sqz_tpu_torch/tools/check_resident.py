"""Check the resident paths on the card (the port of the reference's
``tools/check_resident.py``) on ``synthetic.resident_mix`` (checkpoint-
and activation-like blocks that reach every cell-parse decision),
uploaded once as a tensor on the device:

- the literal-only encode (mode "lit", the cold token kernel) must equal
  ``native.sqz4_compress_payload(..., lz=False)`` on every block;
- the cell parse (mode "rle", the lit_skip kernel) must round-trip
  through the native decoder on every block;
- ``decompress_resident`` of the rle container must restore the input
  with no lane on the host route (no lane the kernel flagged).

    python -m sqz_tpu_torch.tools.check_resident [--bytes N]
        [--blk-bits B] [--device cuda|cpu]
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
from sqz_tpu_torch.utils import synthetic

WINDOW = 1 << 15


def check(args) -> dict:
    dev = resolve_device(args.device)
    bb = args.blk_bits
    bs = 1 << bb
    data = synthetic.resident_mix(max(1, args.bytes >> bb), bb, seed=1)
    parts = [data[o:o + bs] for o in range(0, len(data), bs)]
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    print(f"input {len(data)} B, {len(parts)} blocks of 2^{bb}", flush=True)
    lit, t_lit = timed(lambda: resident.encode_resident_blocks(
        x, bb, "lit", device=dev), dev)
    if lit != [native.sqz4_compress_payload(p, WINDOW, lz=False)
               for p in parts]:
        raise CheckFailed("literal resident payloads differ from the native "
                          "engine's (lz=False)")
    rle, t_rle = timed(lambda: resident.encode_resident_blocks(
        x, bb, "rle", device=dev), dev)
    for b, (p, part) in enumerate(zip(rle, parts)):
        if native.sqz4_decompress_payload(p, len(part)) != part:
            raise CheckFailed(f"rle resident block {b} does not round-trip "
                              f"through the native decoder")
    blob = sqzt.pack(SQZT_FORMAT_SQZ4, 15, bb, len(data), rle, None)
    before = dict(resident.route_lanes)
    out, t_dec = timed(lambda: resident.decompress_resident(
        blob, device=dev), dev)
    routes = {k: resident.route_lanes[k] - before[k] for k in before}
    if out.device.type != dev.type or out.cpu().numpy().tobytes() != data:
        raise CheckFailed("the rle restore differs from the input")
    if routes["host"]:
        raise CheckFailed(f"the rle restore sent lanes to the host: {routes}")
    mb = len(data) / 1e6
    r_lit = sum(map(len, lit)) / len(data)
    r_rle = sum(map(len, rle)) / len(data)
    print(f"OK: on {dev}: lit {mb / t_lit:.1f} MB/s, every payload equal "
          f"to the native engine's; rle {mb / t_rle:.1f} MB/s, ratio "
          f"{r_rle:.4f} (lit {r_lit:.4f}), every block round-trips; the "
          f"rle restore {mb / t_dec:.1f} MB/s, routes {routes}", flush=True)
    return {"resident_lit_MBps": mb / t_lit, "resident_rle_MBps": mb / t_rle,
            "resident_dec_MBps": mb / t_dec, "resident_rle_ratio": r_rle,
            "resident_lit_ratio": r_lit}


def main(argv=None, report: dict = None) -> int:
    return run(check, parser(__doc__, 8 << 20, 16).parse_args(argv), report)


if __name__ == "__main__":
    sys.exit(main())
