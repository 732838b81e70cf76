"""Block-level device engine for sqz4 sqzt containers (the "torch" engine).

Counterpart of the sqz4 cold branches of ``sqz_tpu/ops/engine.py``
(``compress_blocks`` and ``decompress_blocks``): the host planner parses
each block, the device codes and decodes every block of the container in
one kernel launch, and the host assembles the decoded bytes.
"""

from __future__ import annotations

from typing import List, Sequence

from sqz_tpu_torch.ops import sqz4_cuda


def compress_blocks(parts: Sequence[bytes], win_bits: int, lz: bool,
                    blk_bits: int, parse: str = "auto",
                    device="cuda") -> List[bytes]:
    """sqz4 payloads of the container's blocks (every part but the last
    is 2^blk_bits bytes, as ``sqzt.split_blocks`` cuts them)."""
    if any(len(p) != 1 << blk_bits for p in parts[:-1]):
        raise ValueError("every block but the last must be full")
    return sqz4_cuda.encode_data_full(
        b"".join(parts), blk_bits, 1 << win_bits, lz,
        cap=(1 << blk_bits) + 2048, parse=parse, device=device)


def decompress_blocks(payloads: Sequence[bytes], sizes: Sequence[int],
                      blk_bits: int, device="cuda") -> bytes:
    """The concatenated decoded blocks of a cold sqz4 container."""
    return b"".join(sqz4_cuda.decode_groups(list(payloads), list(sizes),
                                            blk_bits, device=device))
