"""What the entries share: the base of an entry, the sample of outputs
the check reads, and the checks of containers and checkpoint files
against ``portbench.reference``. Every check counts faults: each number
is held to the limit 0, since every guarantee of a lossless codec is
exact."""

from __future__ import annotations

import multiprocessing
import os
import random

import numpy as np
import torch

from portbench.reference import checkpoint as ref_ckpt
from portbench.reference import sqz4 as ref_sqz4
from portbench.reference import sqzt as ref_sqzt

SQZ4 = 1
# reference blocks decoded in worker processes past this many (a literal
# block of 64 KiB takes the plain decoder about half a second)
POOL_FROM, POOL_WORKERS = 16, 4


def program():
    import sqz_tpu_torch
    from sqz_tpu_torch.utils import checkpoint
    return sqz_tpu_torch, checkpoint


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Keep:
    """The outputs the check reads: a sample of ``size`` calls drawn from
    the seed as the calls come (reservoir sampling), and the last call.
    ``drop`` releases an output that is no longer kept."""

    def __init__(self, seed: int, size: int, drop=None):
        self.rng = random.Random(seed)
        self.size = size
        self.drop = drop or (lambda out: None)
        self.sample: list = []
        self.last = None
        self.seen = 0

    def add(self, out):
        if self.last is not None:
            prev, self.last = self.last, None
            if len(self.sample) < self.size:
                self.sample.append(prev)
            else:
                j = self.rng.randrange(self.seen)
                if j < self.size:
                    self.drop(self.sample[j])
                    self.sample[j] = prev
                else:
                    self.drop(prev)
        self.last = out
        self.seen += 1

    def outputs(self):
        return self.sample + ([self.last] if self.last is not None else [])

    def clear(self):
        for out in self.outputs():
            self.drop(out)
        self.sample, self.last = [], None


class Entry:
    """One entry of the program. ``ctx`` (``harness.Context``) holds the
    configuration, the traffic, the seed and the device.

    An entry makes at set-up what its calls need and makes one call;
    ``call`` is the timed step; ``in_bytes`` / ``stored_bytes`` size a
    call's output for the end-to-end readers; ``sizes`` gives the
    rooflines the bytes a call reads and writes (after the window, traced
    runs only); ``check`` judges the kept outputs after the window;
    ``broken`` is a call's output with ``fault`` planted (the tests')."""

    takes_stats = False    # the call accepts the program's stats= dict

    def __init__(self, ctx):
        self.ctx = ctx
        self.kw = dict(ctx.cfg.get("codec", {}), **ctx.traffic.get(
            "kwargs", {}))

    def keep(self):
        return Keep(self.ctx.seed, self.ctx.traffic.get("keep", 2),
                    self.drop)

    def stored_bytes(self, out):
        return 0

    def drop(self, out):
        pass

    def close(self):
        pass


def read_fd(fd) -> bytes:
    with open(f"/proc/self/fd/{fd}", "rb") as f:
        return f.read()


def ref_ckpt_bytes(state) -> int:
    leaves: list = []
    ref_ckpt.flatten(state, leaves)
    return sum(x.numel() * x.element_size() for x in leaves)


def bytes_differing(got: bytes, want: bytes) -> int:
    """Differing bytes, a length difference counting each missing or
    extra byte."""
    n = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, n)
    b = np.frombuffer(want, np.uint8, n)
    return int((a != b).sum()) + abs(len(got) - len(want))


def block_picks(counts, strata: dict, count: int, rng: random.Random):
    """(container, block) pairs over containers of ``counts`` blocks: per
    stratum, one block drawn from each group of ``lanes`` blocks and the
    last block of each launch of ``groups`` groups (both in a container
    drawn by ``rng``), the last block of the first container, then
    blocks drawn at random up to ``count`` in all."""
    picks = {(0, counts[0] - 1)}
    lanes, groups = strata.get("lanes", 0), strata.get("groups", 1)
    if lanes:
        for g in range(-(-max(counts) // lanes)):
            c = rng.randrange(len(counts))
            lo, hi = g * lanes, min((g + 1) * lanes, counts[c])
            if lo >= hi:
                continue
            picks.add((c, rng.randrange(lo, hi)))
            if (g + 1) % groups == 0 or hi == counts[c]:
                picks.add((c, hi - 1))
    while len(picks) < min(count, sum(counts)):
        c = rng.randrange(len(counts))
        picks.add((c, rng.randrange(counts[c])))
    return sorted(picks)


def ref_blocks_differing(blobs, expect_bytes, blk_bits: int, traffic: dict,
                         rng: random.Random) -> int:
    """Decode the blocks ``block_picks`` draws over ``blobs`` (the payload
    lists of containers; the traffic's ``ref_blocks`` and
    ``ref_strata``) with the reference decoder, in worker processes where
    they are many; count the blocks that do not decode to their slice of
    the expected bytes (``expect_bytes(lo, hi)``). A container with no
    payloads counts every pick."""
    count = traffic.get("ref_blocks", 8)
    if not blobs or any(not b for b in blobs):
        return count
    bs = 1 << blk_bits
    picks = block_picks([len(b) for b in blobs],
                        traffic.get("ref_strata", {}), count, rng)
    jobs = [(blobs[c][b], expect_bytes(b * bs, (b + 1) * bs))
            for c, b in picks]
    if len(jobs) < POOL_FROM:
        return sum(map(ref_sqz4.block_differs, jobs))
    pool = multiprocessing.get_context("spawn").Pool(
        min(POOL_WORKERS, os.cpu_count() or 1))
    try:
        bad = sum(pool.map(ref_sqz4.block_differs, jobs, chunksize=1))
    finally:
        pool.close()
        pool.join()
    return bad


def container_expect(kw: dict, size: int, checksum=None) -> dict:
    """The fields of a ``compress`` container of ``size`` bytes. The
    checksum is a guarantee of the configuration: a container without it
    breaks it, whatever the call was asked."""
    return dict(fmt=SQZ4, win_bits=kw.get("win_bits", 15),
                blk_bits=kw["blk_bits"], flags=ref_sqzt.FLAG_CHECKSUM,
                size=size, checksum=checksum)


def ckpt_expect(kw: dict, size: int) -> dict:
    """The fields of a checkpoint's container: cold sqz4, no checksum."""
    return dict(fmt=SQZ4, win_bits=15, blk_bits=kw["blk_bits"], flags=0,
                size=size)


def payload_total(blob: bytes, kw: dict, size: int) -> int:
    """Payload bytes of a ``compress`` container (0 where it is broken:
    the check counts that)."""
    _, payloads, _ = ref_sqzt.read(blob, container_expect(kw, size))
    return sum(map(len, payloads))


def file_payload_total(data: bytes, kw: dict, size: int) -> int:
    """Payload bytes of a checkpoint file's container (0 where it is
    broken)."""
    try:
        _, blob = ref_ckpt.read(data)
    except ValueError:
        return 0
    _, payloads, _ = ref_sqzt.read(blob, ckpt_expect(kw, size))
    return sum(map(len, payloads))


def check_containers(ctx, blobs, data: bytes, kw: dict) -> dict:
    """The sqzt containers of ``data``: every field (the FNV-1a64 checksum
    worked out again) and the traffic's blocks through the reference
    decoder."""
    csum = ref_sqzt.fnv1a64(data, device=ctx.device)
    expect = container_expect(kw, len(data), csum)
    bad, payloads = 0, []
    for blob in blobs:
        _, p, b = ref_sqzt.read(blob, expect)
        bad += b
        payloads.append(p)
    rng = random.Random(ctx.seed + 1)
    return {"container_fields_bad": bad,
            "ref_blocks_differing": ref_blocks_differing(
                payloads, lambda lo, hi: data[lo:hi], kw["blk_bits"],
                ctx.traffic, rng)}


def check_files(ctx, files, state, kw: dict, paths=()) -> dict:
    """Checkpoint files of ``state``: the layout, the metadata and the
    container's fields against what the reference works out from the
    state, the traffic's blocks through the reference decoder against the
    reference's filtered stream, and the program's load of each of
    ``paths`` (the same files) against the state."""
    shuffle, delta = kw.get("shuffle", True), kw.get("delta", True)
    structure, metas, stream = ref_ckpt.expected(state, shuffle, delta)
    raw = int(stream.numel())
    bad, payloads = 0, []
    for data in files:
        try:
            meta, blob = ref_ckpt.read(data)
        except ValueError:
            bad += 1
            payloads.append([])
            continue
        bad += ref_ckpt.meta_fields_bad(meta, structure, metas,
                                        kw["blk_bits"])
        _, p, b = ref_sqzt.read(blob, ckpt_expect(kw, raw))
        bad += b
        payloads.append(p)

    def expect_bytes(lo, hi):
        return stream[lo:min(hi, raw)].cpu().numpy().tobytes()

    checks = {"file_fields_bad": bad,
              "ref_blocks_differing": ref_blocks_differing(
                  payloads, expect_bytes, kw["blk_bits"], ctx.traffic,
                  random.Random(ctx.seed + 1))}
    del stream
    if paths:
        _, ckpt = program()
        malformed, differing = 0, 0
        for path in paths:
            try:
                tree = ckpt.load_pytree(path, device=ctx.device)
            except (ValueError, OSError, RuntimeError):
                malformed += len(metas)
                continue
            m, d = ref_ckpt.trees_differ(tree, state)
            malformed += m
            differing += d
            del tree
        checks["roundtrip_leaves_malformed"] = malformed
        checks["roundtrip_bytes_differing"] = differing
    return checks
