"""Block-level device engine of the sqzt containers (the "torch" engine).

Counterpart of ``sqz_tpu/ops/engine.py`` (``compress_blocks`` and
``decompress_blocks``):

- sqz4, cold: the host planner parses each block, the card codes and
  decodes the blocks, and the host assembles the decoded bytes. Every
  cold input encodes through the pipeline (planner thread and card
  overlapped, a launch a group of ``LANES`` blocks, ``ops/pipeline.py``),
  and decodes through ``sqz4_cuda.decode_groups``.
- sqz4, warm (sqzt v2): the cold pass, then, per the warm gate's
  candidates, a seeded pass (blocks 1+ start from block 0's final model
  state and match into its tail): on host threads when there are few
  candidates, else on the card (the seeded op-stream kernel); each block
  keeps the smaller payload. Warm containers (v2, and v3 with anchors,
  FORMAT.md §3.2) decode their anchor blocks on the host first, then one
  cold device batch and one seeded device batch per anchor
  (``_warm_scatter``, the seeded decoder).
- sqz4 at ``blk_bits`` above 16 (17..40), the reference's scan route
  (sqz_tpu/ops/engine.py:141-157, :257-271) on the port's kernels: the
  exact parse, whatever ``parse`` says, and the per-op model statistics,
  then one launch of the stats-fed encoder a group of blocks
  (``sqz4_cuda.encode_data_stats``); warm (v2) codes the warm gate's
  candidates again, seeded from block 0's rescaled final state, each
  block keeping the smaller payload. Decode is the decoder kernel, cold
  and seeded, as at 64 KiB, in groups of ``sqz4_host.group_lanes``
  blocks. The blocks this route serves are counted in ``wide_blocks``.
- squeeze, cold and warm (sqzt v2): the native planner codes every block
  and records its bitstream writes, and the bit-packer kernel assembles
  the payloads (``squeeze_cuda.squeeze_encode_data``). Warm keeps per
  block the smaller of the fresh and the seeded payload; the seeded pass
  runs only for the warm gate's candidates. Decode is the native threaded
  decoder, as in the reference's device engine (v3: the native per-block
  decoder under ``_warm_scatter``): adaptive-Huffman decode is pointer
  chasing with data-dependent tree restructuring, which a lock-step
  device loop runs at microseconds a symbol.

Anchored containers (sqzt v3) are planned on the host (``api.py``).
"""

from __future__ import annotations

from typing import List, Sequence

from sqz_tpu_torch import native
from sqz_tpu_torch.formats.constants import (SQZT_FORMAT_SQUEEZE,
                                             SQZT_FORMAT_SQZ4,
                                             warm_dictionary, warm_gate_mask)
from sqz_tpu_torch.formats.container import resolve_anchors
from sqz_tpu_torch.ops import launch, pipeline, sqz4_cuda, squeeze_cuda
from sqz_tpu_torch.ops.sqz4_host import LANES, group_lanes, parse_mode

# sqz4 blocks above 64 KiB (sqz4_cuda.MAIN_BLK_BITS) that the stats-fed
# route encoded or decoded: a run shows with it which route its
# containers took
wide_blocks = 0


def _pick_smaller(cold: List[bytes], warm: List[bytes], gate=None):
    """Per-block fresh/warm choice (FORMAT.md §3.1). Block 0 is always the
    cold payload; ``gate``: blocks that are no warm-gate candidates stay
    fresh even where a seeded payload exists."""
    out, mask = [], []
    for b, (c, w) in enumerate(zip(cold, warm)):
        fresh = (b == 0 or len(c) <= len(w)
                 or (gate is not None and not gate[b]))
        out.append(c if fresh else w)
        mask.append(fresh)
    return out, mask


def _warm_pass(parts, cold, win_bits, lz, parse, decode_state,
               encode_seeded, device_pass):
    """(payloads, fresh_mask) of a warm container from its cold payloads,
    as the reference's device engine (sqz_tpu/ops/engine.py:119-140,
    :170-184): blocks that the warm gate passes are coded again seeded
    from block 0's final state (``decode_state(payload, size)`` -> (block,
    state)) against its tail; few of them on host threads
    (``encode_seeded(part, seed, dictionary, parse)``), more by the
    device pass (``device_pass()``, every block's seeded payload); each
    block keeps the smaller."""
    dictionary = warm_dictionary(parts[0], win_bits)
    gate = warm_gate_mask(parts, dictionary)
    if not any(gate):
        return cold, [True] * len(parts)
    if not lz:
        dictionary = b""
    if sum(gate) > len(parts) // 4:
        return _pick_smaller(cold, device_pass(), gate)
    # few candidates (the common case): host threads code just those,
    # seeded from the state the decoder derives from block 0
    _blk0, seed = decode_state(cold[0], len(parts[0]))
    warm_p = list(cold)
    host_parse = parse_mode(parse)
    for b in range(1, len(parts)):
        if gate[b]:
            warm_p[b] = encode_seeded(parts[b], seed, dictionary, host_parse)
    return _pick_smaller(cold, warm_p, gate)


def _squeeze_blocks(parts, data, win_bits, lz, blk_bits, warm, parse,
                    device):
    """squeeze payloads (cold) or (payloads, fresh_mask) (warm)."""
    def encode(warm_pass):
        return squeeze_cuda.squeeze_encode_data(
            data, blk_bits, win_bits, cap=(1 << blk_bits) + 4096,
            warm=warm_pass, parse=parse, device=device)

    cold = encode(False)
    if not warm:
        return cold
    return _warm_pass(
        parts, cold, win_bits, lz, parse,
        lambda pl, sz: native.squeeze_decompress_payload(
            pl, sz, return_state=True),
        lambda part, seed, dictionary, host_parse:
            native.squeeze_compress_payload(
                part, win_bits, seed=seed, dictionary=dictionary,
                parse=host_parse),
        lambda: encode(True))


def _wide(nblocks: int):
    """Count ``nblocks`` sqz4 blocks that the route above 64 KiB serves."""
    global wide_blocks
    wide_blocks += nblocks


def _sqz4_wide(parts, data, win_bits, lz, blk_bits, warm, device):
    """sqz4 payloads (cold) or (payloads, fresh_mask) (warm) above 64 KiB
    blocks, as the reference's scan route (sqz_tpu/ops/engine.py:141-157):
    the cold pass, then the warm gate's candidates seeded, each block
    keeping the smaller payload."""
    _wide(len(parts))
    window = 1 << win_bits
    cold = sqz4_cuda.encode_data_stats(data, blk_bits, window, lz,
                                       device=device)
    if not warm:
        return cold
    gate = warm_gate_mask(parts, warm_dictionary(parts[0], win_bits))
    cand = [b for b in range(1, len(parts)) if gate[b]]
    if not cand:
        return cold, [True] * len(parts)
    warm_p = list(cold)
    for b, p in zip(cand, sqz4_cuda.encode_data_stats(
            data, blk_bits, window, lz, warm=True, blocks=cand,
            device=device)):
        warm_p[b] = p
    return _pick_smaller(cold, warm_p, gate)


def _sqz4_blocks(parts, data, win_bits, lz, blk_bits, warm, parse, device):
    """sqz4 payloads (cold) or (payloads, fresh_mask) (warm), as the
    reference's device engine (sqz_tpu/ops/engine.py:97-157)."""
    if blk_bits > sqz4_cuda.MAIN_BLK_BITS:
        return _sqz4_wide(parts, data, win_bits, lz, blk_bits, warm, device)
    bs = 1 << blk_bits
    cold = pipeline.encode_data_pipelined(data, blk_bits, 1 << win_bits, lz,
                                          cap=bs + 2048, parse=parse,
                                          device=device)
    if not warm:
        return cold
    return _warm_pass(
        parts, cold, win_bits, lz, parse,
        lambda pl, sz: native.sqz4_decompress_payload(pl, sz,
                                                      return_state=True),
        lambda part, seed, dictionary, host_parse:
            native.sqz4_compress_payload(
                part, 1 << win_bits, lz=lz, seed=seed,
                dictionary=dictionary, parse=host_parse),
        lambda: sqz4_cuda.encode_data_full(
            data, blk_bits, 1 << win_bits, lz, cap=bs + 2048, parse=parse,
            device=device, warm=True))


def compress_blocks(parts: Sequence[bytes], fmt: int, win_bits: int,
                    lz: bool, blk_bits: int, warm: bool = False,
                    parse: str = "auto", device="cuda"):
    """The container's block payloads (every part but the last is
    2^blk_bits bytes, as ``sqzt.split_blocks`` cuts them) in the sqzt
    format ``fmt``. Cold: payloads. Warm (sqzt v2): (payloads,
    fresh_mask)."""
    if any(len(p) != 1 << blk_bits for p in parts[:-1]):
        raise ValueError("every block but the last must be full")
    with launch.CONTAINER.stage("join"):
        data = b"".join(parts)
    warm = warm and len(parts) > 1
    if fmt == SQZT_FORMAT_SQUEEZE:
        return _squeeze_blocks(parts, data, win_bits, lz, blk_bits, warm,
                               parse, device)
    if fmt != SQZT_FORMAT_SQZ4:
        raise ValueError(f"unknown sqzt format {fmt}")
    return _sqz4_blocks(parts, data, win_bits, lz, blk_bits, warm, parse,
                        device)


def _warm_scatter(payloads, sizes, fresh_mask, anchor_mask, decode_batch,
                  decode_anchor, win_bits: int) -> bytes:
    """Decode a warm container's blocks as parallel batches
    (sqz_tpu/ops/engine.py _warm_scatter): anchor blocks on the host first
    (their final model state seeds the blocks anchored on them; v2: block
    0; v3: every fresh block some warm block anchors on, FORMAT.md §3.2),
    then one cold batch for the other fresh blocks and one seeded batch
    per anchor. ``decode_batch(payloads, sizes, seed, dictionary,
    block_ids)`` -> blocks; ``decode_anchor(payload, size)`` -> (block,
    final state)."""
    anchors = resolve_anchors(fresh_mask, anchor_mask)
    needed = sorted({a for a in anchors if a is not None})
    outs = [None] * len(payloads)
    states = {}
    for a in needed:
        outs[a], seed = decode_anchor(payloads[a], sizes[a])
        states[a] = (seed, warm_dictionary(outs[a], win_bits))
    cold_idx = [b for b in range(len(payloads))
                if fresh_mask[b] and b not in states]
    batches = [(cold_idx, None)] + [
        ([b for b, a in enumerate(anchors) if a == anc], anc)
        for anc in needed]
    for idx, anc in batches:
        if not idx:
            continue
        seed, dictionary = states[anc] if anc is not None else (None, b"")
        batch = decode_batch([payloads[b] for b in idx],
                             [sizes[b] for b in idx], seed, dictionary, idx)
        for b, blk in zip(idx, batch):
            outs[b] = blk
    with launch.CONTAINER.stage("join"):
        return b"".join(outs)


def decompress_blocks(payloads: Sequence[bytes], sizes: Sequence[int],
                      fmt: int, blk_bits: int, fresh_mask=None,
                      win_bits: int = 15, anchor_mask=None,
                      device="cuda") -> bytes:
    """The concatenated decoded blocks of a container in the sqzt format
    ``fmt``, cold or warm (``fresh_mask``, sqzt v2; with ``anchor_mask``,
    v3)."""
    payloads, sizes = list(payloads), list(sizes)
    warm = (fresh_mask is not None and len(payloads) > 1
            and not all(fresh_mask))
    code = 0 if fmt == SQZT_FORMAT_SQUEEZE else 1
    host = fmt == SQZT_FORMAT_SQUEEZE
    wide = not host and blk_bits > sqz4_cuda.MAIN_BLK_BITS
    if wide:
        _wide(len(payloads))
    if host and anchor_mask is None:
        # the native threaded decoder: squeeze (pointer chasing, see the
        # module docstring), cold and v2
        return native.blocks_decompress(
            payloads, sum(sizes), code, blk_bits,
            fresh_mask=fresh_mask if warm else None, win_bits=win_bits)
    decompress_payload = (native.squeeze_decompress_payload if code == 0
                          else native.sqz4_decompress_payload)

    def decode_anchor(pl, sz):
        return decompress_payload(pl, sz, return_state=True)
    if host:
        def decode_batch(pls, szs, seed, dictionary, _ids):
            return [decompress_payload(p, s, seed=seed,
                                       dictionary=dictionary)
                    for p, s in zip(pls, szs)]
    else:
        def decode_batch(pls, szs, seed, dictionary, ids):
            return sqz4_cuda.decode_groups(
                pls, szs, blk_bits, device=device,
                lanes=group_lanes(len(pls)) if wide else LANES,
                block_ids=ids, seed=seed, dictionary=dictionary)
    if not warm:
        outs = decode_batch(payloads, sizes, None, b"",
                            list(range(len(payloads))))
        with launch.CONTAINER.stage("join"):
            return b"".join(outs)
    return _warm_scatter(payloads, sizes, fresh_mask, anchor_mask,
                         decode_batch, decode_anchor, win_bits)
