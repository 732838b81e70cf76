"""Multi-process execution on ``torch.distributed``: bootstrap, the
length-table all-gather, the ordered gather of payloads onto rank 0 (the
port of ``sqz_tpu/parallel/multihost.py``).

Every process runs the same sharded call over its local shards
(``mesh.Mesh``), and codes only the blocks of its shards. The per-block
length table is all-gathered, so every process knows every block's
length; the payloads stay with their process until rank 0 assembles the
container: each process packs its blocks into one byte row of a fixed
layout (``pack_exchange_row``, the reference's, so the two copies stay
verbatim), the rows are all-gathered padded to the longest, and rank 0
splits them by the length table (``unpack_exchange_rows``). A process
without a process group needs no exchange; one in a group of one runs
it all the same.

The collectives run on the process group's backend: NCCL exchanges CUDA
tensors (one rank a card), gloo host tensors (the tests on the CPU, and
two ranks that share one card, whose exchange then rides host memory).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def bootstrap(backend: Optional[str] = None,
              init_method: Optional[str] = None,
              world_size: Optional[int] = None, rank: Optional[int] = None,
              device="cuda") -> bool:
    """Initialise ``torch.distributed`` for a multi-process run, from the
    arguments (``init_method`` such as ``tcp://localhost:<port>``, with
    ``world_size`` and ``rank``) or from torchrun's environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). A no-op without either
    (returns False), and when a process group exists already (returns
    True). ``backend`` defaults to "nccl" for a mesh on the card
    (``device`` "cuda") and "gloo" on the CPU; NCCL takes one rank a
    card, so ranks that share a card pass "gloo"."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if not all(k in os.environ for k in TORCHRUN_ENV):
            return False                            # single-process run
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def grouped() -> bool:
    """Whether a process group exists: then the exchange runs over it,
    at world size 1 too."""
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(this process's rank, the world size); (0, 1) without a group."""
    if grouped():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _comm_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_rows(row: np.ndarray) -> np.ndarray:
    """Every rank's ``row`` (one shape and dtype on every rank) ->
    [world, *row.shape] on every rank, in rank order."""
    t = torch.from_numpy(np.ascontiguousarray(row)).to(_comm_device())
    parts = [torch.empty_like(t) for _ in range(world()[1])]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def all_gather_lengths(local_lens, counts: Sequence[int]) -> np.ndarray:
    """The replicated length table: this rank's lengths of its blocks
    (rank r holds ``counts[r]`` blocks, the ranks' blocks in rank order)
    -> every block's length, on every rank."""
    local = np.asarray(local_lens, np.int64).reshape(-1)
    if not grouped():
        return local
    row = np.zeros(max(max(counts), 1), np.int64)
    row[:local.size] = local
    rows = all_gather_rows(row)
    return np.concatenate([rows[r, :c] for r, c in enumerate(counts)])


def all_gather_bytes(local: torch.Tensor, counts: Sequence[int]):
    """This rank's 1-D uint8 tensor (rank r's holds ``counts[r]`` bytes)
    -> every rank's bytes in rank order, on ``local``'s device, on every
    rank."""
    if not grouped():
        return local
    dev = _comm_device()
    row = torch.zeros(max(max(counts), 1), dtype=torch.uint8, device=dev)
    row[:local.numel()] = local.to(dev)
    parts = [torch.empty_like(row) for _ in counts]
    dist.all_gather(parts, row)
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).to(
        local.device)


def failed_ranks(ok: bool) -> List[int]:
    """The ranks whose ``ok`` is False (one all-gather), so that every
    rank raises when one rank's shards fail, and none waits on a
    collective that the failed rank never joins."""
    if not grouped():
        return [] if ok else [0]
    flags = all_gather_rows(np.array([0 if ok else 1], np.int64))[:, 0]
    return np.nonzero(flags)[0].tolist()


def gather_payloads_to_host0(local_blocks: Sequence[Tuple[int, bytes]],
                             lens: np.ndarray,
                             n_blocks: int) -> Optional[List[bytes]]:
    """Ordered gather of variable-length payloads onto rank 0.

    Every process calls this collectively with its (global block index,
    payload) pairs and the replicated length table. Returns the full
    ordered payload list on rank 0 and None elsewhere. Without a process
    group: a pure reshuffle."""
    lens = np.asarray(lens).reshape(-1)[:n_blocks]
    if not grouped():
        out: List[Optional[bytes]] = [None] * n_blocks
        for b, p in local_blocks:
            out[b] = p
        missing = [i for i, p in enumerate(out) if p is None]
        if missing:
            raise ValueError(
                f"blocks missing from local shards: {missing[:4]}")
        return out                                 # type: ignore[return-value]
    # fixed-shape exchange buffer: every process packs its blocks (sorted
    # by global index) into a byte row padded to the largest process load
    my_ids, buf_row = pack_exchange_row(local_blocks, lens)
    counts = all_gather_rows(np.array([my_ids.size, buf_row.size],
                                      np.int64))
    max_n = max(int(counts[:, 0].max()), 1)
    max_bytes = max(int(counts[:, 1].max()), 1)
    ids_row = np.full(max_n, -1, np.int64)
    ids_row[:my_ids.size] = my_ids
    buf_row = np.concatenate(
        [buf_row, np.zeros(max_bytes - buf_row.size, np.uint8)])
    all_ids = all_gather_rows(ids_row)                       # [P, max_n]
    all_buf = all_gather_rows(buf_row)                       # [P, max_bytes]
    if world()[0] != 0:
        return None
    return unpack_exchange_rows(all_ids, all_buf, lens, n_blocks)


def pack_exchange_row(
        local_blocks: Sequence[Tuple[int, bytes]],
        lens: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One process's exchange row: (sorted global ids, concatenated payload
    bytes in id order). ``lens`` (the replicated length table): each
    payload is padded to its table length so the unpack side's offsets
    stay aligned even when a block's bytes were clamped at the kernel
    buffer (the oversized-warm-block case — those blocks are re-encoded
    on host 0 afterwards, the exchange only has to keep neighbors intact)."""
    my_ids = np.array(sorted(b for b, _ in local_blocks), np.int64)
    by_id = dict(local_blocks)
    if lens is not None:
        lens = np.asarray(lens).reshape(-1)
        buf = b"".join(by_id[int(b)].ljust(int(lens[b]), b"\0")[:int(lens[b])]
                       for b in my_ids)
    else:
        buf = b"".join(by_id[int(b)] for b in my_ids)
    return my_ids, np.frombuffer(buf, np.uint8).copy()


def unpack_exchange_rows(all_ids: np.ndarray, all_buf: np.ndarray,
                         lens: np.ndarray, n_blocks: int) -> List[bytes]:
    """Inverse of pack_exchange_row over every process's gathered row,
    splitting each byte row with the replicated length table."""
    lens = np.asarray(lens).reshape(-1)
    out: List[Optional[bytes]] = [None] * n_blocks
    for pr in range(all_ids.shape[0]):
        off = 0
        for b in all_ids[pr]:
            if b < 0:
                break
            n = int(lens[b])
            out[int(b)] = all_buf[pr, off:off + n].tobytes()
            off += n
    missing = [i for i, p in enumerate(out) if p is None]
    if missing:
        raise ValueError(f"blocks missing from exchange: {missing[:4]}")
    return out                                     # type: ignore[return-value]
