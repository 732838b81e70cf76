"""Block-level device engine for sqz4 sqzt containers (the "torch" engine).

Counterpart of the sqz4 cold branches of ``sqz_tpu/ops/engine.py``
(``compress_blocks`` and ``decompress_blocks``): the host planner parses
each block, the device codes and decodes the blocks, and the host
assembles the decoded bytes. Inputs of more than one group (``LANES``
blocks) encode through the pipeline (planner thread and card overlapped,
``ops/pipeline.py``) unless SQZ_PIPELINE is "0"; smaller ones in one
launch (``sqz4_cuda.encode_data_full``). Both give the same payloads.
"""

from __future__ import annotations

import os
from typing import List, Sequence

from sqz_tpu_torch.ops import pipeline, sqz4_cuda
from sqz_tpu_torch.ops.sqz4_host import LANES


def compress_blocks(parts: Sequence[bytes], win_bits: int, lz: bool,
                    blk_bits: int, parse: str = "auto",
                    device="cuda") -> List[bytes]:
    """sqz4 payloads of the container's blocks (every part but the last
    is 2^blk_bits bytes, as ``sqzt.split_blocks`` cuts them)."""
    if any(len(p) != 1 << blk_bits for p in parts[:-1]):
        raise ValueError("every block but the last must be full")
    encode = (pipeline.encode_data_pipelined
              if len(parts) > LANES
              and os.environ.get("SQZ_PIPELINE", "1") != "0"
              else sqz4_cuda.encode_data_full)
    return encode(b"".join(parts), blk_bits, 1 << win_bits, lz,
                  cap=(1 << blk_bits) + 2048, parse=parse, device=device)


def decompress_blocks(payloads: Sequence[bytes], sizes: Sequence[int],
                      blk_bits: int, device="cuda") -> bytes:
    """The concatenated decoded blocks of a cold sqz4 container."""
    decode = (pipeline.decode_data_pipelined if len(payloads) > LANES
              else sqz4_cuda.decode_groups)
    return b"".join(decode(list(payloads), list(sizes), blk_bits,
                           device=device))
