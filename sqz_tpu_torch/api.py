"""Public API of the port: compress / decompress with the reference's
signatures (``sqz_tpu.api``) plus an explicit ``device``.

Engines:
  * ``torch``  — the device engine: sqz4 ``sqzt`` containers coded by the
    CUDA kernels (``device="cuda"``) or by their plain PyTorch versions
    (``device="cpu"``, for tests);
  * ``native`` and ``oracle`` — the reference's host engines, called as
    they are.

Not served yet by the torch engine (each raises NotImplementedError
naming its ROADMAP item): warm start, the squeeze format, and the
resident paths.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

from sqz_tpu import api as ref_api
from sqz_tpu.api import Format
from sqz_tpu.formats import container as sqzt
from sqz_tpu.formats.constants import SQZT_FORMAT_SQUEEZE, SQZT_FORMAT_SQZ4


class Engine(str, enum.Enum):
    ORACLE = "oracle"
    NATIVE = "native"
    TORCH = "torch"


def _todo(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to the torch engine yet "
        f"(ROADMAP.md, Queue 1 item {item})")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def compress(data: bytes, fmt: Format | str = Format.SQUEEZE,
             engine: Engine | str = Engine.NATIVE,
             win_bits: int = 15, lz: bool = True,
             blocks: bool = False, blk_bits: int = 16,
             checksum: bool = True, warm: "bool | str" = False,
             parse: str = "auto", anchor_beam: int = 4,
             device="cuda") -> bytes:
    """See ``sqz_tpu.api.compress``. ``engine="torch"`` takes sqz4 sqzt
    containers (``blocks=True``, ``blk_bits`` <= 16) and codes them on
    ``device``; ``parse`` 'exact' gives the native engine's bytes."""
    fmt, engine = Format(fmt), Engine(engine)
    if engine is not Engine.TORCH:
        return ref_api.compress(data, fmt, engine.value, win_bits, lz,
                                blocks, blk_bits, checksum, warm, parse,
                                anchor_beam)
    if not 10 <= win_bits <= 15:
        raise ValueError(f"win_bits {win_bits} outside 10..15")
    if warm not in (False, True, "anchors"):
        raise ValueError(f"warm must be bool or 'anchors', got {warm!r}")
    if not blocks:
        raise ValueError("torch engine requires blocks=True (sqzt container)")
    if not 1 <= blk_bits <= 40:
        raise ValueError(f"blk_bits {blk_bits} outside 1..40")
    parts = sqzt.split_blocks(data, blk_bits)
    if warm and len(parts) > 1:
        raise _todo("warm start", 5)
    if fmt is Format.SQUEEZE:
        raise _todo("the squeeze format", 7)
    dev = _device(device)
    from sqz_tpu_torch.ops import engine as torch_engine
    payloads = torch_engine.compress_blocks(parts, win_bits, lz, blk_bits,
                                            parse=parse, device=dev)
    csum = sqzt.fnv1a64(data) if checksum else None
    return sqzt.pack(SQZT_FORMAT_SQZ4, win_bits, blk_bits, len(data),
                     payloads, csum)


def decompress(blob: bytes, fmt: Optional[Format | str] = None,
               engine: Engine | str = Engine.NATIVE,
               device="cuda") -> bytes:
    """See ``sqz_tpu.api.decompress``. ``engine="torch"`` takes cold sqz4
    sqzt containers and decodes them on ``device``; a corrupt block raises
    ValueError naming it."""
    engine = Engine(engine)
    if engine is not Engine.TORCH:
        return ref_api.decompress(blob, fmt, engine.value)
    if blob[:8] != sqzt.SQZT_MAGIC:
        raise ValueError("torch engine requires an sqzt container")
    code, _win_bits, blk_bits, osize, payloads, csum, fresh, _anch = \
        sqzt.unpack(blob)
    if code == SQZT_FORMAT_SQUEEZE:
        raise _todo("the squeeze format", 7)
    if fresh is not None and len(payloads) > 1 and not all(fresh):
        raise _todo("warm start", 5)
    dev = _device(device)
    from sqz_tpu_torch.ops import engine as torch_engine
    bs = 1 << blk_bits
    sizes = [max(0, min(bs, osize - i * bs)) for i in range(len(payloads))]
    data = torch_engine.decompress_blocks(payloads, sizes, blk_bits,
                                          device=dev)
    if csum is not None and sqzt.fnv1a64(data) != csum:
        raise ValueError("sqzt checksum mismatch (EILSEQ)")
    return data


def compress_resident(data, blk_bits: int = 16, mode: str = "rle",
                      checksum: bool = False, interpret: bool = False,
                      mesh=None, lanes: int = None) -> bytes:
    """Not ported yet: see ``sqz_tpu.api.compress_resident``."""
    raise _todo("compress_resident", 8)


def decompress_resident(blob: bytes, interpret: bool = False, mesh=None,
                        lanes: int = None, assembly: str = "auto"):
    """Not ported yet: see ``sqz_tpu.api.decompress_resident``."""
    raise _todo("decompress_resident", 8)


__all__ = ["Engine", "Format", "compress", "decompress",
           "compress_resident", "decompress_resident"]
