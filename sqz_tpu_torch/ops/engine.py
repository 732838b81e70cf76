"""Block-level device engine of the sqzt containers (the "torch" engine).

Counterpart of ``sqz_tpu/ops/engine.py`` (``compress_blocks`` and
``decompress_blocks``) for the formats the port serves:

- sqz4, cold: the host planner parses each block, the card codes and
  decodes the blocks, and the host assembles the decoded bytes. Inputs of
  more than one group (``LANES`` blocks) encode through the pipeline
  (planner thread and card overlapped, ``ops/pipeline.py``) unless
  SQZ_PIPELINE is "0"; smaller ones in one launch
  (``sqz4_cuda.encode_data_full``). Both give the same payloads.
- squeeze, cold and warm (sqzt v2): the native planner codes every block
  and records its bitstream writes, and the bit-packer kernel assembles
  the payloads (``squeeze_cuda.squeeze_encode_data``). Warm keeps per
  block the smaller of the fresh and the seeded payload; the seeded pass
  runs only for the warm gate's candidates. Decode is the native threaded
  decoder, as in the reference's device engine: adaptive-Huffman decode
  is pointer chasing with data-dependent tree restructuring, which a
  lock-step device loop runs at microseconds a symbol.
"""

from __future__ import annotations

import os
from typing import List, Sequence

from sqz_tpu_torch import native
from sqz_tpu_torch.formats.constants import (SQZT_FORMAT_SQUEEZE,
                                             SQZT_FORMAT_SQZ4,
                                             warm_dictionary, warm_gate_mask)
from sqz_tpu_torch.ops import pipeline, sqz4_cuda, squeeze_cuda
from sqz_tpu_torch.ops.sqz4_host import LANES, parse_mode


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


def _squeeze_blocks(parts, data, win_bits, lz, blk_bits, warm, parse,
                    device):
    """squeeze payloads (cold) or (payloads, fresh_mask) (warm), as the
    reference's device engine (sqz_tpu/ops/engine.py:158-184)."""
    def encode(warm_pass):
        return squeeze_cuda.squeeze_encode_data(
            data, blk_bits, win_bits, cap=(1 << blk_bits) + 4096,
            warm=warm_pass, parse=parse, device=device)

    cold = encode(False)
    if not warm:
        return cold
    dictionary = warm_dictionary(parts[0], win_bits)
    gate = warm_gate_mask(parts, dictionary)
    if not any(gate):
        return cold, [True] * len(parts)
    if not lz:
        dictionary = b""
    if sum(gate) <= len(parts) // 4:
        # few candidates (the common case): host threads code just those,
        # seeded from the state the decoder derives from block 0
        _blk0, seed = native.squeeze_decompress_payload(
            cold[0], len(parts[0]), return_state=True)
        warm_p = list(cold)
        host_parse = parse_mode(parse)
        for b in range(1, len(parts)):
            if gate[b]:
                warm_p[b] = native.squeeze_compress_payload(
                    parts[b], win_bits, seed=seed, dictionary=dictionary,
                    parse=host_parse)
        return _pick_smaller(cold, warm_p, gate)
    return _pick_smaller(cold, encode(True), gate)


def compress_blocks(parts: Sequence[bytes], fmt: int, win_bits: int,
                    lz: bool, blk_bits: int, warm: bool = False,
                    parse: str = "auto", device="cuda"):
    """The container's block payloads (every part but the last is
    2^blk_bits bytes, as ``sqzt.split_blocks`` cuts them) in the sqzt
    format ``fmt``. Cold: payloads. Warm (squeeze only): (payloads,
    fresh_mask)."""
    if any(len(p) != 1 << blk_bits for p in parts[:-1]):
        raise ValueError("every block but the last must be full")
    data = b"".join(parts)
    if fmt == SQZT_FORMAT_SQUEEZE:
        return _squeeze_blocks(parts, data, win_bits, lz, blk_bits,
                               warm and len(parts) > 1, parse, device)
    if fmt != SQZT_FORMAT_SQZ4 or warm:
        raise ValueError(f"the torch engine codes cold sqz4 and squeeze "
                         f"blocks, not format {fmt} with warm={warm}")
    encode = (pipeline.encode_data_pipelined
              if len(parts) > LANES
              and os.environ.get("SQZ_PIPELINE", "1") != "0"
              else sqz4_cuda.encode_data_full)
    return encode(data, blk_bits, 1 << win_bits, lz,
                  cap=(1 << blk_bits) + 2048, parse=parse, device=device)


def decompress_blocks(payloads: Sequence[bytes], sizes: Sequence[int],
                      fmt: int, blk_bits: int, fresh_mask=None,
                      win_bits: int = 15, device="cuda") -> bytes:
    """The concatenated decoded blocks of a container in the sqzt format
    ``fmt``: cold sqz4, or squeeze, cold or warm (``fresh_mask``, sqzt
    v2)."""
    if fmt == SQZT_FORMAT_SQUEEZE:
        warm = (fresh_mask is not None and len(payloads) > 1
                and not all(fresh_mask))
        return native.blocks_decompress(
            list(payloads), sum(sizes), 0, blk_bits,
            fresh_mask=fresh_mask if warm else None, win_bits=win_bits)
    decode = (pipeline.decode_data_pipelined if len(payloads) > LANES
              else sqz4_cuda.decode_groups)
    return b"".join(decode(list(payloads), list(sizes), blk_bits,
                           device=device))
