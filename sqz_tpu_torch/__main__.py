"""CLI of the port: compress / decompress / round-trip verify, random-access
reads and checkpoints, with the subcommands and options of ``python -m
sqz_tpu`` (bits-per-symbol and ratio report, first-diff index on a verify
failure). The port's defaults hold: format sqz4, engine torch on the card
(``--device cuda``; ``--device cpu`` runs the plain versions).

Usage:
  python -m sqz_tpu_torch compress   <in> <out> [--format squeeze|sqz4]
                                     [--engine torch|native|oracle]
                                     [--device cuda|cpu] [--win-bits 15]
                                     [--blocks] [--blk-bits 16] [--no-lz]
                                     [--warm | --warm-anchors]
                                     [--resident lit|rle]
  python -m sqz_tpu_torch decompress <in> <out> [--engine ...]
  python -m sqz_tpu_torch roundtrip  <file...>  [same options] [--stats]
  python -m sqz_tpu_torch range      <in> START:LENGTH [--engine native]
  python -m sqz_tpu_torch ckpt-save  <in.npz|in.npy> <out> [--mode rle]
  python -m sqz_tpu_torch ckpt-load  <in> <out.npz>
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import sqz_tpu_torch


def _add_device(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the torch engine and the resident paths "
                        "run (cpu: their plain versions)")


def _add_common(p):
    p.add_argument("--format", default="sqz4", choices=["squeeze", "sqz4"])
    p.add_argument("--engine", default="torch",
                   choices=["torch", "native", "oracle"])
    _add_device(p)
    p.add_argument("--win-bits", type=int, default=15)
    p.add_argument("--blocks", action="store_true",
                   help="use the block-parallel sqzt container (the torch "
                        "engine always does)")
    p.add_argument("--blk-bits", type=int, default=16)
    p.add_argument("--no-lz", action="store_true",
                   help="literal-only (sqz4: reference HEAD behavior)")
    p.add_argument("--warm", action="store_true",
                   help="sqzt v2 warm start: per-block fresh/seeded choice "
                        "(FORMAT.md §3.1); implies --blocks")
    p.add_argument("--warm-anchors", action="store_true",
                   help="sqzt v3 anchored warm start: beam-planned per-block "
                        "anchor choice (FORMAT.md §3.2); implies --blocks")
    p.add_argument("--anchor-beam", type=int, default=4,
                   help="beam width for --warm-anchors planning")
    p.add_argument("--resident", choices=["lit", "rle"],
                   help="device-resident encode (ops/resident.py): zero "
                        "host planning; 'lit' = literal-only reference "
                        "HEAD semantics, 'rle' adds the device periodic "
                        "cell parse. sqz4/sqzt only; implies --blocks")


def _compress(args, data: bytes) -> bytes:
    if getattr(args, "resident", None):
        return sqz_tpu_torch.compress_resident(
            data, blk_bits=args.blk_bits, mode=args.resident, checksum=True,
            device=args.device)
    warm = "anchors" if args.warm_anchors else args.warm
    blocks = args.blocks or bool(warm) or args.engine == "torch"
    return sqz_tpu_torch.compress(
        data, fmt=args.format, engine=args.engine, win_bits=args.win_bits,
        lz=not args.no_lz, blocks=blocks, blk_bits=args.blk_bits,
        warm=warm, anchor_beam=args.anchor_beam, device=args.device)


def _decompress(args, blob: bytes) -> bytes:
    return sqz_tpu_torch.decompress(blob, engine=args.engine,
                                    device=args.device)


def first_diff(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return -1 if len(a) == len(b) else n


def _npz_array(name: str, t):
    """A restored tensor -> a numpy array for ``np.savez``; bfloat16 has
    no numpy dtype (without ml_dtypes) and raises."""
    import torch
    if t.dtype == torch.bfloat16:
        raise ValueError(f"leaf {name!r} is bfloat16, which numpy cannot "
                         f"hold: restore it with sqz_tpu_torch.utils."
                         f"checkpoint.load_pytree() instead")
    return t.cpu().numpy()


def _print_stats(args, data: bytes):
    """Token telemetry of ``data`` (the SQUEEZE_MAP_STATS analog) from the
    native copy's greedy tokenizer."""
    from sqz_tpu_torch import native
    from sqz_tpu_torch.utils.stats import (analyze_tokens, count_rejections,
                                           sqz4_model_report)
    min_len, max_len = (3, 257) if args.format == "squeeze" else (2, 254)
    toks = native.tokenize(data, 1 << args.win_bits, min_len, max_len,
                           reject_short_far=args.format == "sqz4")
    tokens = [("lit", int(a)) if k == 0 else ("match", int(a), int(b))
              for k, a, b in toks]
    print(analyze_tokens(tokens).report())
    if args.format == "sqz4":
        # full SQUEEZE_MAP_STATS breadth (src/sqz.c:744-790): per-model
        # entropies and the short-far rejection counter
        print(sqz4_model_report(tokens))
        print(f"rejections: {count_rejections(data, 1 << args.win_bits)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sqz_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("compress")
    pc.add_argument("infile")
    pc.add_argument("outfile")
    _add_common(pc)
    pd = sub.add_parser("decompress")
    pd.add_argument("infile")
    pd.add_argument("outfile")
    _add_common(pd)
    pr = sub.add_parser("roundtrip")
    pr.add_argument("files", nargs="+")
    pr.add_argument("--stats", action="store_true",
                    help="print token telemetry (SQUEEZE_MAP_STATS analog)")
    _add_common(pr)
    pg = sub.add_parser("range",
                        help="random-access decode from an sqzt container")
    pg.add_argument("infile")
    pg.add_argument("span", help="START:LENGTH (bytes)")
    pg.add_argument("--engine", default="native",
                    choices=["native", "oracle"])
    pg.add_argument("--out", help="write bytes here instead of stdout")
    pk = sub.add_parser("ckpt-save",
                        help="compress a .npy/.npz array file through the "
                             "device-resident checkpoint codec "
                             "(utils/checkpoint.py)")
    pk.add_argument("infile")
    pk.add_argument("outfile")
    pk.add_argument("--blk-bits", type=int, default=16)
    pk.add_argument("--mode", choices=["lit", "rle"], default="rle")
    pk.add_argument("--no-shuffle", action="store_true",
                    help="skip the byte-plane transpose filter")
    pk.add_argument("--no-delta", action="store_true",
                    help="skip the byte-delta filter")
    _add_device(pk)
    pl = sub.add_parser("ckpt-load",
                        help="restore a ckpt-save file back to .npz")
    pl.add_argument("infile")
    pl.add_argument("outfile")
    _add_device(pl)
    args = ap.parse_args(argv)

    if args.cmd == "ckpt-save":
        import numpy as np

        from sqz_tpu_torch.utils import checkpoint as ckpt
        loaded = np.load(args.infile, allow_pickle=False)
        tree = ({k: loaded[k] for k in loaded.files}
                if hasattr(loaded, "files") else {"arr_0": loaded})
        stats = ckpt.save_pytree(tree, args.outfile,
                                 blk_bits=args.blk_bits, mode=args.mode,
                                 shuffle=not args.no_shuffle,
                                 delta=not args.no_delta, device=args.device)
        print(f"{stats['raw_bytes']:9d} -> {stats['compressed_bytes']:9d} "
              f"{stats['ratio'] * 100.0:6.2f}%")
        return 0

    if args.cmd == "ckpt-load":
        import numpy as np

        from sqz_tpu_torch.utils import checkpoint as ckpt
        tree = ckpt.load_pytree(args.infile, device=args.device)
        if not isinstance(tree, dict):
            print("ckpt-load writes .npz and needs a dict-of-arrays "
                  "checkpoint (ckpt-save produces those); this file holds "
                  f"a {type(tree).__name__} — restore it with "
                  "sqz_tpu_torch.utils.checkpoint.load_pytree()",
                  file=sys.stderr)
            return 1
        out = args.outfile if args.outfile.endswith(".npz") \
            else args.outfile + ".npz"     # np.savez appends it anyway
        np.savez(out, **{k: _npz_array(k, v) for k, v in tree.items()})
        print(f"restored {len(tree)} arrays -> {out}")
        return 0

    if args.cmd == "range":
        blob = Path(args.infile).read_bytes()
        start, length = (int(x) for x in args.span.split(":"))
        out = sqz_tpu_torch.decompress_range(blob, start, length,
                                             engine=args.engine)
        if args.out:
            Path(args.out).write_bytes(out)
        else:
            sys.stdout.buffer.write(out)
        return 0

    if args.cmd == "compress":
        data = Path(args.infile).read_bytes()
        t0 = time.perf_counter()
        blob = _compress(args, data)
        dt = time.perf_counter() - t0
        Path(args.outfile).write_bytes(blob)
        bps = len(blob) * 8.0 / max(len(data), 1)
        print(f"bps: {bps:4.1f} {len(data):9d} -> {len(blob):9d} "
              f"{len(blob) * 100.0 / max(len(data), 1):6.2f}% "
              f"{len(data) / dt / 1e6:8.1f} MB/s")
        return 0

    if args.cmd == "decompress":
        blob = Path(args.infile).read_bytes()
        t0 = time.perf_counter()
        data = _decompress(args, blob)
        dt = time.perf_counter() - t0
        Path(args.outfile).write_bytes(data)
        print(f"{len(blob):9d} -> {len(data):9d} "
              f"{len(data) / dt / 1e6:8.1f} MB/s")
        return 0

    # roundtrip
    rc = 0
    for fn in args.files:
        p = Path(fn)
        if not p.exists():
            print(f"skip (missing): {fn}")
            continue
        data = p.read_bytes()
        t0 = time.perf_counter()
        blob = _compress(args, data)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = _decompress(args, blob)
        t_dec = time.perf_counter() - t0
        bps = len(blob) * 8.0 / max(len(data), 1)
        print(f"bps: {bps:4.1f} {len(data):9d} -> {len(blob):9d} "
              f"{len(blob) * 100.0 / max(len(data), 1):6.2f}% of \"{p.name}\" "
              f"enc {len(data) / t_enc / 1e6:7.1f} MB/s "
              f"dec {len(data) / t_dec / 1e6:7.1f} MB/s")
        if back != data:
            print(f"  VERIFY FAILED: first diff at byte "
                  f"{first_diff(data, back)}")
            rc = 1
        if args.stats:
            _print_stats(args, data)
    return rc


if __name__ == "__main__":
    sys.exit(main())
