"""``compress(data, parse="exact")`` of one host buffer: the compress
entry, whose check also holds the traffic's blocks to the exact parse,
the guarantee its callers ask for: each block's payload is the plain
exact-parse encoder's (``portbench.reference.sqz4_exact``) byte for
byte."""

from __future__ import annotations

import multiprocessing
import os
import random

from portbench.entries import common, compress
from portbench.reference import sqz4_exact
from portbench.reference import sqzt as ref_sqzt


def exact_blocks_differing(blobs, data: bytes, kw: dict, traffic: dict,
                           rng: random.Random) -> int:
    """The blocks ``common.block_picks`` draws over the containers
    ``blobs`` (the traffic's ``ref_blocks`` and ``ref_strata``) whose
    payload is not the exact-parse payload of their slice of ``data``, in
    worker processes where they are many. A broken container counts
    every pick."""
    count = traffic.get("ref_blocks", 8)
    payloads = [ref_sqzt.read(blob, common.container_expect(
        kw, len(data)))[1] for blob in blobs]
    if not payloads or any(not p for p in payloads):
        return count
    bs, window = 1 << kw["blk_bits"], 1 << kw.get("win_bits", 15)
    picks = common.block_picks([len(p) for p in payloads],
                               traffic.get("ref_strata", {}), count, rng)
    jobs = [(payloads[c][b], data[b * bs:(b + 1) * bs], window)
            for c, b in picks]
    if len(jobs) < common.POOL_FROM:
        return sum(map(sqz4_exact.block_differs, jobs))
    pool = multiprocessing.get_context("spawn").Pool(
        min(common.POOL_WORKERS, os.cpu_count() or 1))
    try:
        bad = sum(pool.map(sqz4_exact.block_differs, jobs, chunksize=1))
    finally:
        pool.close()
        pool.join()
    return bad


class Entry(compress.Entry):
    def check(self, kept):
        checks = super().check(kept)
        checks["exact_blocks_differing"] = exact_blocks_differing(
            kept, self.data, self.kw, self.ctx.traffic,
            random.Random(self.ctx.seed + 2))
        return checks


class Control(Entry):
    """The program's fast parse in the exact parse's place."""

    def call(self, stats):
        return self.sqz.compress(self.data, device=self.ctx.device,
                                 **dict(self.kw, parse="fast"))
