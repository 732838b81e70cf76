"""Pipelined sqz4 encode: overlap the host planner with the card
(counterpart of ``sqz_tpu/ops/pipeline.py``), the engine's cold encode at
64 KiB blocks and below.

The input is cut into groups of ``lanes`` blocks. A planner thread plans
group k+1 (and k+2: the queue holds two) while the main thread uploads
group k from pinned host memory, runs its kernel on a CUDA stream of its
own and downloads its payloads compacted on the card, group after group
in order. The native planner releases the GIL, so the two threads run at
once. The parse picks the transport: the fast parse uploads one u32 token
per parse decision plus packed literals (~1.1 B per input byte) to the
token kernel; the exact parse uploads micro-op streams (~4.5 B/B) to the
op-stream kernel.

Payloads equal ``sqz4_cuda.encode_data_full``'s for the same parse:
grouping only batches the launches, and every block is coded from its own
op sequence and fresh models.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List

import numpy as np
import torch

from sqz_tpu_torch import native
from sqz_tpu_torch.ops import launch, sqz4_cuda, sqz4_host as host


def _plan_ops(chunk: bytes, blk_bits: int, window: int, lz: bool,
              lanes: int, pin: bool):
    """One group's exact-parse op streams as int32 [1, rows, lanes] host
    tensors (``native.sqz4_plan_pack``), in pinned memory if ``pin``."""
    mw, sw, mx = native.sqz4_plan_pack(chunk, window, blk_bits, lz, lanes,
                                       host.op_stream_cap(blk_bits))
    rows = -(-int(mx) // 4)
    out = []
    for a in (mw[:, :rows], sw[:, :rows]):
        t = torch.empty(a.shape, dtype=torch.int32, pin_memory=pin)
        t.numpy()[...] = a.view(np.int32)
        out.append(t)
    return out


def encode_data_pipelined(data: bytes, blk_bits: int, window: int, lz: bool,
                          cap: int, parse: str = "auto", lanes: int = None,
                          device="cuda", tok_cap: int = None,
                          stats: dict = None) -> List[bytes]:
    """Whole-buffer sqz4 encode with host/device overlap; returns the
    per-block payloads (the contract of ``sqz4_cuda.encode_data_full``).

    ``parse`` as in ``encode_data_full`` (SQZ_PARSE overrides): 'fast'
    takes the token kernel, 'exact' the op-stream kernel; ``lanes``
    blocks a group (default 512); ``tok_cap`` overrides the token cap
    (blocks over it take the op-stream kernel).

    ``stats`` (optional dict) gets the active wall seconds of each stage
    (the stages ``sqz.pipeline.<stage>`` of a profile): plan_s (planner
    thread), wait_plan_s (main thread waiting for a plan), dispatch_s
    (uploads and kernel launches), fence_s (waiting for the kernel),
    fetch_s (payload download and unpacking) and wall_s. The stages
    overlap: a sum above wall_s measures the overlap. No stage waits for
    the card: the fence is where the main thread does."""
    if stats is not None:
        stats.update(dict.fromkeys(("plan_s", "wait_plan_s", "dispatch_s",
                                    "fence_s", "fetch_s"), 0.0))
        t_wall = time.perf_counter()
    st = launch.Stages("pipeline", stats)
    sqz4_cuda.check_main_blk_bits(blk_bits)
    dev = torch.device(device)
    tok = host.parse_mode(parse) == "fast"
    lanes = lanes or host.LANES
    pin = dev.type == "cuda"
    bs = 1 << blk_bits
    gbytes = bs * lanes
    groups = max(1, -(-len(data) // gbytes))

    # ---- planner thread: one group at a time into a queue of two
    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()                 # set on a main-loop failure

    def planner():
        try:
            for g in range(groups):
                if stop.is_set():
                    break
                with st.stage("plan"):
                    chunk = data[g * gbytes:(g + 1) * gbytes]
                    if tok:
                        plan = sqz4_cuda.plan_tok_group(
                            chunk, blk_bits, window, lz, tok_cap, pin)
                    else:
                        plan = _plan_ops(chunk, blk_bits, window, lz, lanes,
                                         pin)
                q.put((chunk, plan))
        except BaseException as e:           # surface planner errors
            q.put(e)
            return
        q.put(None)

    thread = threading.Thread(target=planner, name="sqz4-planner",
                              daemon=True)
    thread.start()

    # ---- main thread: upload, launch and download each group in order
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    payloads: List[bytes] = []
    try:
        with torch.cuda.stream(stream):
            while True:
                with st.stage("wait_plan"):
                    item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                chunk, plan = item
                if tok:
                    payloads += sqz4_cuda.encode_tok_group(
                        plan, chunk, blk_bits, window, lz, cap, dev, st)
                else:
                    payloads += _encode_ops_group(plan, chunk, blk_bits, cap,
                                                  dev, st)
    except BaseException:
        # cancel and unblock the planner (bounded queue) so the thread
        # exits after at most its current group
        stop.set()
        while thread.is_alive():
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
        raise
    thread.join()
    if stats is not None:
        stats["wall_s"] = time.perf_counter() - t_wall
    return payloads


def _encode_ops_group(plan, chunk: bytes, blk_bits: int, cap: int, dev,
                      st: launch.Stages) -> List[bytes]:
    """One planned group of op streams through the op-stream kernel."""
    nb = max(1, -(-len(chunk) // (1 << blk_bits)))
    with st.stage("dispatch"):
        m, s = (x.to(dev, non_blocking=True).view(torch.uint32)
                for x in plan)
        words, lens = sqz4_cuda.encode_full(m, s, host.cap_words_for(cap))
    return sqz4_cuda.collect_group(words, lens, nb, st)
