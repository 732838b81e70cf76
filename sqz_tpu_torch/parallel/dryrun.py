"""The port's counterparts of the reference's driver entry points
(``__graft_entry__.py``): ``entry`` (one compile-and-run check of the
op-stream encoder at tiny shapes) and ``dryrun_multichip`` (the sharded
codec over a mesh of n virtual shards of one device, every leg held
byte for byte against the native engine or the single-device path), and
the worker of a multi-process run:

    python -m sqz_tpu_torch.parallel.dryrun --rank R --world W --port P
        [--backend gloo|nccl] [--device cuda|cpu] [--blocks N]
        [--blk-bits B] [--out DIR]

Each worker joins the process group at ``tcp://localhost:P`` with one
shard of ``--device``, codes ``synthetic.resident_mix(N, B, seed=1)``
through ``compress_resident(mesh=)`` in mode rle (rank 0 writes the
container to ``DIR/rle.sqzt``; every other rank must get None), then
restores that file through ``decompress_resident(mesh=)``, which must
give every rank the input. It exits non-zero on a failed check. Two
ranks on one card take ``--backend gloo`` (NCCL takes one rank a card).
"""

from __future__ import annotations

import argparse
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

from sqz_tpu_torch.ops import sqz4_host as host
from sqz_tpu_torch.ops.launch import resolve_device


def entry(device="cuda"):
    """(fn, example_args): the op-stream encoder (``sqz4_cuda.
    encode_full``) on the reference's tiny batch, 8 blocks of 256
    literals (bytes 0..63, numpy seed 0), as micro-op words on
    ``device``. ``fn(*args)`` gives (payload words, lengths)."""
    from sqz_tpu_torch.ops import sqz4_cuda
    from sqz_tpu_torch.parallel.shard import op_words, token_op_rows
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    tokens = [[("lit", int(b)) for b in rng.integers(0, 64, size=256)]
              for _ in range(8)]
    fn = partial(sqz4_cuda.encode_full, cap_words=host.cap_words_for(1024))
    return fn, op_words(*token_op_rows(tokens), dev)


def _equal(got, want, what: str):
    if got != want:
        bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b) \
            if len(got) == len(want) else "count"
        raise AssertionError(f"{what}: differs (block {bad})")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The block-parallel codec over ``n_devices`` virtual shards of
    ``device``, two blocks a shard at tiny shapes, each leg byte-equal
    to its reference: token lists through the op-stream encoder, cold
    and warm (one seed), against the native encoder; the whole-buffer
    encode (host planner, op-stream encoder), cold and warm, against the
    native encoder; the resident encode in modes rle and lz against the
    single-device path (lz blocks also round-trip)."""
    from sqz_tpu_torch import native
    from sqz_tpu_torch.ops import resident
    from sqz_tpu_torch.parallel import shard
    from sqz_tpu_torch.parallel.mesh import make_mesh
    from sqz_tpu_torch.utils import corpus
    dev = resolve_device(device)
    mesh = make_mesh(n_devices, devices=[dev] * n_devices)
    n = mesh.size
    blocks = [corpus.texty(192, seed=i) for i in range(2 * n)]
    tokens = [[("lit", b) for b in blk] for blk in blocks]
    _equal(shard.encode_blocks_sharded(tokens, 8, mesh),
           [native.sqz4_compress_payload(b, 1 << 8, lz=False)
            for b in blocks], "sharded token encode")
    _, seed = native.sqz4_compress_payload(blocks[0], 1 << 8, lz=False,
                                           return_state=True)
    _equal(shard.encode_blocks_sharded(tokens, 8, mesh,
                                       seeds=[None] + [seed] * (2 * n - 1)),
           [native.sqz4_compress_payload(b, 1 << 8, lz=False,
                                         seed=seed if i else None)
            for i, b in enumerate(blocks)], "sharded warm token encode")
    data = corpus.texty(2 * n * 256, seed=99)
    parts = [data[i * 256:(i + 1) * 256] for i in range(2 * n)]
    _equal(shard.encode_data_sharded(data, 8, 1 << 8, mesh),
           [native.sqz4_compress_payload(p, 1 << 8, lz=True) for p in parts],
           "sharded encode")
    _, seed_p = native.sqz4_compress_payload(parts[0], 1 << 8, lz=True,
                                             return_state=True)
    _equal(shard.encode_data_sharded(data, 8, 1 << 8, mesh, warm=True),
           [native.sqz4_compress_payload(
               p, 1 << 8, lz=True, seed=seed_p if i else None,
               dictionary=parts[0][-256:] if i else b"")
            for i, p in enumerate(parts)], "sharded warm encode")
    rdata = bytes(256) + corpus.texty(640, seed=5) + b"ab" * 128
    _equal(shard.encode_resident_sharded(rdata, 8, mesh, mode="rle"),
           resident.encode_resident_blocks(rdata, 8, "rle", device=dev),
           "sharded resident rle")
    lzdata = (corpus.texty(3 * n * 256, seed=7) + bytes(128)
              + b"xyz" * 100)
    lzp = shard.encode_resident_sharded(lzdata, 8, mesh, mode="lz")
    _equal(lzp, resident.encode_resident_blocks(lzdata, 8, "lz",
                                                device=dev),
           "sharded resident lz")
    for i, p in enumerate(lzp):
        blk = lzdata[i * 256:(i + 1) * 256]
        if native.sqz4_decompress_payload(p, len(blk)) != blk:
            raise AssertionError(f"lz block {i} does not round-trip")
    print(f"dryrun_multichip({n_devices}): {2 * n} blocks over {n} "
          f"virtual shards of {dev} (token lists cold and warm, the "
          f"op-stream encoder cold and warm, resident rle and lz), "
          f"payloads byte-equal to their references", flush=True)


def worker(argv=None) -> int:
    """One rank of the multi-process run (see the module)."""
    import torch.distributed as dist

    import sqz_tpu_torch
    from sqz_tpu_torch.parallel import multihost
    from sqz_tpu_torch.parallel.mesh import make_mesh
    from sqz_tpu_torch.utils import synthetic
    ap = argparse.ArgumentParser(description="one rank of a multi-process "
                                             "resident run")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--blocks", type=int, default=512)
    ap.add_argument("--blk-bits", type=int, default=16)
    ap.add_argument("--out", default=".")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    multihost.bootstrap(args.backend, f"tcp://localhost:{args.port}",
                        args.world, args.rank, dev)
    try:
        mesh = make_mesh(1, devices=[dev])
        data = synthetic.resident_mix(args.blocks, args.blk_bits, seed=1)
        x = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
        t = time.perf_counter()
        blob = sqz_tpu_torch.compress_resident(x, blk_bits=args.blk_bits,
                                               mode="rle", mesh=mesh)
        enc_s = time.perf_counter() - t
        path = Path(args.out) / "rle.sqzt"
        if (blob is None) != (args.rank != 0):
            raise AssertionError(f"rank {args.rank} got "
                                 f"{'no ' if blob is None else 'a '}"
                                 f"container")
        if blob is not None:
            path.write_bytes(blob)
        dist.barrier()
        t = time.perf_counter()
        out = sqz_tpu_torch.decompress_resident(path.read_bytes(), mesh=mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dec_s = time.perf_counter() - t
        if out.device != dev or out.cpu().numpy().tobytes() != data:
            raise AssertionError("the restore over the process group "
                                 "differs from the input")
        print(f"rank {args.rank} of {args.world} ({dist.get_backend()}, "
              f"{dev}): {len(data)} B, enc {enc_s:.3f} s, dec {dec_s:.3f} "
              f"s", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(worker())
