"""Check the sqz4 encoder kernels against the native encoder: the
op-stream encoder's payloads (exact parse) and the stats-fed encoder's
(the reference's ``tools/check_pallas_enc.py`` codes per-op statistics)
must equal ``native.sqz4_compress_payload(..., lz=True)`` on every block
of pseudo-text.

    python -m sqz_tpu_torch.tools.check_enc [--bytes N] [--blk-bits B]
        [--device cuda|cpu]
"""

from __future__ import annotations

import sys

from sqz_tpu_torch import native
from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host
from sqz_tpu_torch.ops.launch import resolve_device
from sqz_tpu_torch.tools import CheckFailed, parser, run, timed
from sqz_tpu_torch.utils import corpus

WINDOW = 1 << 15


def first_difference(got, want) -> str:
    bad = [b for b, (p, q) in enumerate(zip(got, want)) if p != q]
    if not bad:
        return ""
    p, q = got[bad[0]], want[bad[0]]
    i = next((k for k in range(min(len(p), len(q))) if p[k] != q[k]),
             min(len(p), len(q)))
    return (f"{len(bad)} of {len(want)} blocks differ; block {bad[0]}: "
            f"lengths {len(p)} and {len(q)}, first difference at byte {i}")


def check(args) -> dict:
    dev = resolve_device(args.device)
    data = corpus.texty(args.bytes, seed=1)
    bs = 1 << args.blk_bits
    parts = [data[o:o + bs] for o in range(0, len(data), bs)]
    cap = 2 * bs + 4096
    base, t_native = timed(lambda: [native.sqz4_compress_payload(
        p, WINDOW, lz=True) for p in parts], dev)
    full, t_full = timed(lambda: sqz4_cuda.encode_data_full(
        data, args.blk_bits, WINDOW, True, cap, parse="exact", device=dev),
        dev)
    diff = first_difference(full, base)
    if diff:
        raise CheckFailed(f"op-stream encoder: {diff}")
    start, size, total = host.op_stream_stats(data, WINDOW, args.blk_bits)
    stats, t_stats = timed(lambda: sqz4_cuda.encode_groups(
        start, size, total, cap, device=dev), dev)
    diff = first_difference(stats, base)
    if diff:
        raise CheckFailed(f"stats-fed encoder: {diff}")
    mb = len(data) / 1e6
    print(f"OK: the op-stream and the stats-fed encoder on {dev}: all "
          f"{len(parts)} payloads of 2^{args.blk_bits}-byte blocks equal "
          f"the native encoder's; op-stream {mb / t_full:.1f} MB/s incl. "
          f"the host planner, stats-fed {mb / t_stats:.1f} MB/s from the "
          f"statistics (native 1-thread {mb / t_native:.1f} MB/s)",
          flush=True)
    return {"enc_blocks": len(parts), "enc_MBps": mb / t_full,
            "enc_stats_MBps": mb / t_stats, "enc_native_MBps": mb / t_native}


def main(argv=None, report: dict = None) -> int:
    return run(check, parser(__doc__, 2 << 20, 14).parse_args(argv), report)


if __name__ == "__main__":
    sys.exit(main())
