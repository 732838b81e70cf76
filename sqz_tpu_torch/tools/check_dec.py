"""Check the sqz4 decoder kernel against the native decoder: every block
of a container of pseudo-text, then seeded corrupt mutants of its
payloads through the compiled kernel (the port of the reference's
``tools/check_pallas_dec.py``).

    python -m sqz_tpu_torch.tools.check_dec [--bytes N] [--blk-bits B]
        [--mutants M] [--device cuda|cpu]

Each mutant (``random.Random(1234)``; kind ``t % 4``: a bit flip, a byte
substitution, a truncation, a zeroed 8-byte span) decodes through
``sqz4_cuda.decode_groups`` and through the native decoder, under the
reference's contract: a rejection on the card (ValueError) is fine unless
the native decoder restores the original block; an output on the card
must equal the native decoder's wherever that one produces; where the
native decoder rejects and the card produces, the output must be the
block's length.
"""

from __future__ import annotations

import random
import sys

from sqz_tpu_torch import native
from sqz_tpu_torch.ops import sqz4_cuda
from sqz_tpu_torch.ops.launch import resolve_device
from sqz_tpu_torch.tools import CheckFailed, parser, run, timed
from sqz_tpu_torch.utils import corpus

WINDOW = 1 << 15
MUTANT_SEED = 1234


def mutate(payload: bytes, t: int, rng: random.Random) -> bytes:
    """Mutant ``t`` of ``payload`` (the reference's four kinds, drawn from
    ``rng`` in its order)."""
    pl = bytearray(payload)
    kind = t % 4
    if kind == 0 and len(pl) > 1:                       # single bit flip
        pl[rng.randrange(len(pl))] ^= 1 << rng.randrange(8)
    elif kind == 1 and len(pl) > 1:                     # byte substitution
        pl[rng.randrange(len(pl))] = rng.randrange(256)
    elif kind == 2 and len(pl) > 4:                     # truncation
        del pl[rng.randrange(1, len(pl) - 1):]
    else:                                               # zeroed span
        i = rng.randrange(max(1, len(pl) - 8))
        pl[i:i + 8] = b"\x00" * min(8, len(pl) - i)
    return bytes(pl)


def check_mutants(payloads, parts, blk_bits: int, n: int, dev):
    """(rejected, produced) of ``n`` mutants on ``dev``; CheckFailed at
    the first that breaks the contract."""
    rng = random.Random(MUTANT_SEED)
    rejected = produced = 0
    for t in range(n):
        b = rng.randrange(len(payloads))
        mutant = mutate(payloads[b], t, rng)
        size = len(parts[b])
        try:
            nat, nat_err = native.sqz4_decompress_payload(mutant, size), None
        except OSError as e:
            nat, nat_err = None, e.errno
        try:
            out = sqz4_cuda.decode_groups([mutant], [size], blk_bits,
                                          device=dev)[0]
        except ValueError:
            out = None
        if out is None:
            rejected += 1
            if nat_err is None and nat == parts[b]:
                raise CheckFailed(f"mutant {t} (block {b}, kind {t % 4}): "
                                  f"rejected a stream the native decoder "
                                  f"restores to the original block")
            continue
        produced += 1
        if nat_err is None and out != nat:
            raise CheckFailed(f"mutant {t} (block {b}, kind {t % 4}): the "
                              f"output differs from the native decoder's")
        if nat_err is not None and len(out) != size:
            raise CheckFailed(f"mutant {t} (block {b}, kind {t % 4}): "
                              f"{len(out)} B where the native decoder "
                              f"raised errno {nat_err}")
    return rejected, produced


def check(args) -> dict:
    dev = resolve_device(args.device)
    data = corpus.texty(args.bytes, seed=1)
    bs = 1 << args.blk_bits
    parts = [data[o:o + bs] for o in range(0, len(data), bs)]
    sizes = [len(p) for p in parts]
    payloads = [native.sqz4_compress_payload(p, WINDOW, lz=True)
                for p in parts]
    base, t_native = timed(lambda: [native.sqz4_decompress_payload(p, n)
                                    for p, n in zip(payloads, sizes)], dev)
    if b"".join(base) != data:
        raise CheckFailed("the native decoder does not round-trip")
    outs, t_dev = timed(lambda: sqz4_cuda.decode_groups(
        payloads, sizes, args.blk_bits, device=dev), dev)
    bad = [b for b, (o, p) in enumerate(zip(outs, parts)) if o != p]
    if bad:
        raise CheckFailed(f"{len(bad)} of {len(parts)} blocks differ from "
                          f"the input, first block {bad[0]}")
    mb = len(data) / 1e6
    print(f"decoder on {dev}: {len(parts)} blocks of 2^{args.blk_bits} "
          f"equal to the input; {mb / t_dev:.1f} MB/s incl. host pack and "
          f"assembly (native 1-thread {mb / t_native:.1f} MB/s)", flush=True)
    rejected, produced = check_mutants(payloads, parts, args.blk_bits,
                                       args.mutants, dev)
    print(f"OK: {args.mutants} corrupt mutants through the decoder on "
          f"{dev} ({rejected} rejected, {produced} produced; all "
          f"consistent with the native decoder)", flush=True)
    return {"dec_blocks": len(parts), "dec_MBps": mb / t_dev,
            "dec_native_MBps": mb / t_native, "mutants": args.mutants,
            "mutants_rejected": rejected, "mutants_produced": produced}


def main(argv=None, report: dict = None) -> int:
    ap = parser(__doc__, 2 << 20, 14)
    ap.add_argument("--mutants", type=int, default=100,
                    help="corrupt mutants (default 100)")
    return run(check, ap.parse_args(argv), report)


if __name__ == "__main__":
    sys.exit(main())
