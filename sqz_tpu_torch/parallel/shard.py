"""The block-parallel codec over a mesh (the port of
``sqz_tpu/parallel/shard.py``).

Blocks split into contiguous ranges, one a shard (``shard_ranges``), and
every shard codes its own range with the single-device path's kernels on
its own device and stream; a process issues the shards of one device
from one host thread, those of distinct devices from a thread each
(``_on_shards``). The length
table is all-gathered, rank 0 assembles the ordered payloads
(``multihost.gather_payloads_to_host0``), and every output equals the
single-device output byte for byte:

- ``encode_resident_sharded`` / ``decompress_resident_sharded``: the
  resident paths (``ops/resident.py``): lit and rle onto the token
  encoder's lit_skip mode, lz onto the device LZ matcher; the restore
  through the decoder and the cell or general assembly per shard, as
  ``assembly`` asks;
- ``encode_data_sharded``: the host planner (exact parse) on the whole
  buffer, then the op-stream encoder per shard, cold or ``warm`` (its
  seeded mode; block 0 stays cold);
- ``decode_blocks_sharded``: the decoder per shard, raising on a corrupt
  block;
- ``encode_blocks_sharded``: token lists through the op-stream encoder
  (the reference runs its XLA scan here; the bytes are the same).

Unlike the reference, the LZ path codes up to ``resident.LZ_LANES`` (512)
blocks a launch as the single-device path does, reads no environment
variable, and the mesh restore keeps ``assembly``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from sqz_tpu_torch import convert, native
from sqz_tpu_torch.formats.constants import (PM_BITS, PM_BYTE, PM_DIST0,
                                             PM_LITERAL, PM_ROWS, PM_SIZE,
                                             SQZ4_EOS)
from sqz_tpu_torch.ops import resident, sqz4_cuda, sqz4_host as host
from sqz_tpu_torch.parallel import multihost
from sqz_tpu_torch.parallel.mesh import Mesh, check_mesh

OP_FLUSH = PM_ROWS   # microops_from_tokens' flush id (the kernels' is 254)
OP_PAD = 255         # the kernels' pad op


def shard_ranges(nb: int, n: int, lanes: int):
    """(blocks a launch, [(first, stop) of each of the ``n`` shards]):
    ceil(nb / n) blocks a shard, rounded up to whole launches of
    min(lanes, that) blocks, the ranges contiguous and cut at ``nb``. The
    reference pads the block count to a multiple of n x lanes; these are
    its ranges without the padding."""
    nb = max(nb, 1)
    per = -(-nb // n)
    width = min(lanes, per)
    per = -(-per // width) * width
    return width, [(min(nb, s * per), min(nb, (s + 1) * per))
                   for s in range(n)]


def _local_ranges(mesh: Mesh, ranges):
    return [ranges[mesh.global_shard(i)] for i in range(mesh.local_size)]


def _rank_counts(mesh: Mesh, ranges, sizes=None) -> List[int]:
    """Blocks (or, with per-block ``sizes``, bytes) of each rank's
    shards."""
    k = mesh.local_size
    out = []
    for r in range(mesh.world):
        rr = ranges[r * k:(r + 1) * k]
        out.append(sum(b - a for a, b in rr) if sizes is None
                   else int(sum(sum(sizes[a:b]) for a, b in rr)))
    return out


def _on_shards(mesh: Mesh, work):
    """``work(i, dev)`` for every local shard i, each on its device and
    stream (the stream waits first for the caller's current stream): the
    shards of one device one after another from one host thread, those
    of distinct devices from a host thread each. Returns the results in
    shard order, after the caller's current streams wait for an event
    each shard recorded after its work. A shard's exception is raised on
    every rank (on the others as a ValueError naming the rank).

    Shards of one card share its host thread: a thread a shard ran the
    restore several times slower, the shards' many small ops contending
    for the interpreter lock (PERF.md, PR 10; ``scripts/mesh_issue.py``
    times both)."""
    for d, s in zip(mesh.devices, mesh.streams):
        if s is not None:
            s.wait_stream(torch.cuda.current_stream(d))

    def one(i):
        dev, stream = mesh.devices[i], mesh.streams[i]
        if stream is None:
            return work(i, dev), None
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            out = work(i, dev)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def run(shards):
        return [(i, one(i)) for i in shards]

    by_device: dict = {}
    for i, d in enumerate(mesh.devices):
        by_device.setdefault(d, []).append(i)
    results, error = {}, None
    if len(by_device) == 1:
        try:
            results.update(run(range(mesh.local_size)))
        except Exception as e:   # noqa: BLE001 - told to every rank, raised
            error = e
    else:
        with ThreadPoolExecutor(len(by_device),
                                thread_name_prefix="sqz-device") as ex:
            futures = [ex.submit(run, idx) for idx in by_device.values()]
        for f in futures:
            try:
                results.update(f.result())
            except Exception as e:   # noqa: BLE001 - as above
                error = error or e
    bad = multihost.failed_ranks(error is None)
    if error is not None:
        raise error
    if bad:
        raise ValueError(f"sharded work failed on rank(s) {bad}")
    for i, d in enumerate(mesh.devices):
        if results[i][1] is not None:
            torch.cuda.current_stream(d).wait_event(results[i][1])
    return [results[i][0] for i in range(mesh.local_size)]


def _gather(mesh: Mesh, results, ranges, nb: int):
    """The shards' (block, payload) pairs -> the ordered payloads on rank
    0 (None elsewhere), through the all-gathered length table."""
    local = [p for r in results for p in r]
    lens = multihost.all_gather_lengths([len(p) for _, p in local],
                                        _rank_counts(mesh, ranges))
    return multihost.gather_payloads_to_host0(local, lens, nb)


def _flat(data):
    """bytes, a uint8 numpy array or a uint8 tensor -> (a 1-D sliceable
    view, its length)."""
    if isinstance(data, (torch.Tensor, np.ndarray)):
        flat = data.reshape(-1)
        return flat, int(flat.shape[0])
    flat = memoryview(bytes(data))
    return flat, len(flat)


def encode_resident_sharded(data, blk_bits: int, mesh: Mesh,
                            mode: str = "rle",
                            lanes: int = None) -> Optional[List[bytes]]:
    """The resident encode (``resident.encode_resident_blocks``) with
    blocks sharded over ``mesh``: bytes or a uint8 tensor in, the ordered
    per-block payloads out on rank 0 (None elsewhere). Every shard parses
    and codes its own blocks on its device, ``lanes`` (default 512) blocks
    a launch."""
    check_mesh(mesh)
    group, gargs, width = resident.resident_coder(blk_bits, mode, lanes)
    bs = 1 << blk_bits
    flat, n = _flat(data)
    nb = max(1, -(-n // bs))
    width, ranges = shard_ranges(nb, mesh.size, width)
    coder = (group, gargs, width)

    def work(i, dev):
        a, b = _local_ranges(mesh, ranges)[i]
        if a == b:
            return []
        rows = resident.encode_rows(flat[a * bs:b * bs], blk_bits, coder,
                                    dev)
        return list(enumerate(rows, a))

    return _gather(mesh, _on_shards(mesh, work), ranges, nb)


def decompress_resident_sharded(blob: bytes, mesh: Mesh, lanes: int = None,
                                assembly: str = "auto"):
    """The resident restore (``resident.decompress_resident``) with blocks
    sharded over ``mesh``: each shard decodes and assembles its own blocks
    on its device (``assembly`` as the single-device path takes it), and
    the result, a 1-D uint8 tensor of the whole container on the mesh's
    first local device, is on every rank (the ranks' bytes all-gathered
    over the process group)."""
    check_mesh(mesh)
    resident.check_assembly(assembly)
    blk_bits, _osize, payloads, sizes = resident.unpack_cold_container(blob)
    width, ranges = shard_ranges(len(payloads), mesh.size,
                                 lanes or host.LANES)

    def work(i, dev):
        a, b = _local_ranges(mesh, ranges)[i]
        if a == b:
            return torch.zeros(0, dtype=torch.uint8, device=dev)
        return resident.restore_blocks(payloads[a:b], sizes[a:b], blk_bits,
                                       width, assembly, dev)

    parts = _on_shards(mesh, work)
    home = mesh.devices[0]
    for t, d in zip(parts, mesh.devices):
        if t.is_cuda:   # read on the caller's stream from here on
            t.record_stream(torch.cuda.current_stream(d))
    local = torch.cat([t.to(home) for t in parts])
    return multihost.all_gather_bytes(local,
                                      _rank_counts(mesh, ranges, sizes))


def encode_data_sharded(data: bytes, blk_bits: int, window: int, mesh: Mesh,
                        lz: bool = True, lanes: int = None,
                        warm: bool = False) -> Optional[List[bytes]]:
    """Whole-buffer sqz4 encode with blocks sharded over ``mesh`` (the
    reference's ``encode_data_sharded_pallas``): the native planner (exact
    parse) on the host, then the op-stream encoder on each shard's
    blocks. ``warm`` runs the all-seeded pass of ``sqz4_cuda.
    encode_data_full(warm=True)``: blocks 1+ start from block 0's final
    model state (the seeded kernel) and match into its tail; a block past
    the kernel's capacity is coded again on the host codec, seeded the
    same way. Payloads equal ``encode_data_full(parse="exact")``'s; rank
    0 gets them (None elsewhere)."""
    check_mesh(mesh)
    sqz4_cuda.check_blk_bits(blk_bits)
    bs = 1 << blk_bits
    nb = max(1, -(-len(data) // bs))
    warm = warm and nb > 1
    width, ranges = shard_ranges(nb, mesh.size, lanes or host.LANES)
    plan = native.sqz4_plan_pack(data, window, blk_bits, lz, width,
                                 host.op_stream_cap(blk_bits), warm=warm)
    mw, sw, mx = plan[:3]
    rows = -(-int(mx) // 4)
    seed = plan[3] if warm else None
    cap = bs + 2048
    cap_words = host.cap_words_for(cap + bs // 4 if warm else cap)
    dictionary = data[:bs][-window:] if lz else b""

    def work(i, dev):
        a, b = _local_ranges(mesh, ranges)[i]
        if a == b:
            return []
        g0, g1 = a // width, -(-b // width)
        m_ops, s_ops = convert.encoder_inputs(mw[g0:g1], sw[g0:g1], rows,
                                              dev)
        seed_t = (convert.to_device(host.seed_column(seed), dev) if warm
                  else None)
        words, lens = sqz4_cuda.encode_full(m_ops, s_ops, cap_words, seed_t,
                                            0 if warm and a == 0 else -1)
        lens = convert.to_numpy(lens)
        over = np.nonzero(lens[:, 0].reshape(-1)[:b - a] > cap_words * 4)[0]
        if over.size and not warm:
            raise ValueError("compressed block exceeded the output capacity")
        pls = host.unpack_group_payloads(
            convert.to_numpy(words[:, :host.trimmed_rows(lens)]), lens, b - a)
        for j in over.tolist():
            blk = a + j
            pls[j] = native.sqz4_compress_payload(
                data[blk * bs:(blk + 1) * bs], window, lz=lz,
                seed=seed if blk else None,
                dictionary=dictionary if blk else b"")
        return list(enumerate(pls, a))

    return _gather(mesh, _on_shards(mesh, work), ranges, nb)


def decode_blocks_sharded(payloads: Sequence[bytes], sizes: Sequence[int],
                          blk_bits: int, mesh: Mesh,
                          lanes: int = None) -> Optional[List[bytes]]:
    """Payloads sharded by block over ``mesh``, the decoder and the host
    assembly per shard (``sqz4_cuda.decode_groups``), the decoded blocks
    gathered in order on rank 0 (None elsewhere). A corrupt block raises
    ValueError naming it (on every rank)."""
    check_mesh(mesh)
    sqz4_cuda.check_blk_bits(blk_bits)
    nb = len(payloads)
    width, ranges = shard_ranges(nb, mesh.size, lanes or host.LANES)

    def work(i, dev):
        a, b = _local_ranges(mesh, ranges)[i]
        if a >= min(b, nb):
            return []
        outs = sqz4_cuda.decode_groups(list(payloads[a:b]),
                                       list(sizes[a:b]), blk_bits,
                                       device=dev, lanes=width,
                                       block_ids=range(a, b))
        return list(enumerate(outs, a))

    local = [p for r in _on_shards(mesh, work) for p in r]
    return multihost.gather_payloads_to_host0(
        local, np.asarray(sizes, np.int64), nb)


def microops_from_tokens(tokens):
    """Flatten a token list into (model_id, symbol) micro-op arrays,
    including the EOS token and the 8 flush emissions (FORMAT.md §2.4).
    A copy of ``sqz_tpu/ops/sqz4_jax.py``'s."""
    ms: list[int] = []
    ss: list[int] = []
    for tok in tokens:
        if tok[0] == "lit":
            ms += [PM_LITERAL, PM_BYTE]
            ss += [1, tok[1]]
        else:
            _, length, dist = tok
            nbits = int(dist).bit_length()
            ms += [PM_LITERAL, PM_SIZE, PM_BITS]
            ss += [0, length, nbits]
            d = dist
            for b in range(nbits - 1):
                ms.append(PM_DIST0 + b)
                ss.append(d & 1)
                d >>= 1
    ms += [PM_LITERAL, PM_SIZE] + [OP_FLUSH] * 8
    ss += [0, SQZ4_EOS] + [0] * 8
    return np.asarray(ms, dtype=np.int32), np.asarray(ss, dtype=np.int32)


def token_op_rows(token_lists):
    """Token lists -> (models, symbols) uint8 [blocks, T] micro-op rows
    in the kernels' codes (flush 254, pad 255), T a multiple of 4."""
    ops = [microops_from_tokens(t) for t in token_lists]
    t = -(-max(len(m) for m, _ in ops) // 4) * 4
    m8 = np.full((len(ops), t), OP_PAD, np.uint8)
    s8 = np.zeros((len(ops), t), np.uint8)
    for b, (m, s) in enumerate(ops):
        m8[b, :len(m)] = np.where(m == OP_FLUSH, host.OP_FLUSH, m)
        s8[b, :len(s)] = s
    return m8, s8


def op_words(m8, s8, dev):
    """Micro-op rows [n, T] -> the op-stream encoder's m_ops, s_ops
    (uint32 [1, T/4, n]) on ``dev``."""
    return tuple(sqz4_cuda.pack_ops_words(torch.from_numpy(
        np.ascontiguousarray(x)[None]).to(dev)) for x in (m8, s8))


def _one_seed(seeds, nb: int):
    """The warm seed of ``seeds`` (per block None or one model seed: a
    native state array or an object with ``flat``), None if all are
    None; ValueError unless every seeded block has the same seed (the
    sqzt v2 schedule the seeded kernel codes)."""
    if seeds is None:
        return None
    if len(seeds) != nb:
        raise ValueError(f"{len(seeds)} seeds for {nb} blocks")
    flats = [np.asarray(getattr(s, "flat", s), np.int64).reshape(-1)
             for s in seeds if s is not None]
    if flats and any(not np.array_equal(f, flats[0]) for f in flats):
        raise ValueError("the seeded kernel takes one warm seed for every "
                         "seeded block")
    return flats[0].astype(np.uint32) if flats else None


def encode_blocks_sharded(token_lists: Sequence[list], blk_bits: int,
                          mesh: Mesh, seeds=None) -> Optional[List[bytes]]:
    """Token lists (("lit", byte) and ("match", length, dist)) -> sqz4
    payloads, blocks sharded over ``mesh``, each shard's micro-op
    streams (``microops_from_tokens``) through the op-stream encoder; the
    ordered payloads on rank 0 (None elsewhere). ``seeds``: per block
    None (cold) or the warm seed, one seed for every seeded block (sqzt
    v2); a shard launches its cold and its seeded blocks apart."""
    check_mesh(mesh)
    sqz4_cuda.check_blk_bits(blk_bits)
    nb = len(token_lists)
    seed = _one_seed(seeds, nb)
    m8, s8 = token_op_rows(token_lists)
    seeded = np.array([seeds is not None and seeds[b] is not None
                       for b in range(nb)])
    cap_words = host.cap_words_for((1 << blk_bits) * 2 + 4096)
    _width, ranges = shard_ranges(nb, mesh.size, host.LANES)

    def work(i, dev):
        a, b = _local_ranges(mesh, ranges)[i]
        out = []
        for warm in (False, True):
            ids = [k for k in range(a, b) if seeded[k] == warm]
            if not ids:
                continue
            m_ops, s_ops = op_words(m8[ids], s8[ids], dev)
            seed_t = (convert.to_device(host.seed_column(seed), dev)
                      if warm else None)
            words, lens = sqz4_cuda.encode_full(m_ops, s_ops, cap_words,
                                                seed_t)
            lens = convert.to_numpy(lens)
            if int(lens[0, 0, :len(ids)].max()) > cap_words * 4:
                raise ValueError("compressed block exceeded the output "
                                 "capacity")
            out += zip(ids, host.unpack_group_payloads(
                convert.to_numpy(words[:, :host.trimmed_rows(lens)]), lens,
                len(ids)))
        return out

    return _gather(mesh, _on_shards(mesh, work), ranges, nb)
