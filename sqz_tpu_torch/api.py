"""Public API of the port: compress / decompress with the reference's
signatures (``sqz_tpu.api``) plus an explicit ``device``.

The one engine served is ``torch``, the default: sqz4 ``sqzt`` containers
coded by the CUDA kernels on ``device="cuda"`` (the default; without a
card it raises) or by their plain PyTorch versions on ``device="cpu"``
(for tests).

Not served yet (each raises NotImplementedError naming its ROADMAP item):
the host engines ``native`` and ``oracle``, warm start, the squeeze
format, and the resident paths.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

from sqz_tpu_torch.formats import container as sqzt
from sqz_tpu_torch.formats.constants import (SQZT_FORMAT_SQUEEZE,
                                             SQZT_FORMAT_SQZ4)


class Format(str, enum.Enum):
    SQUEEZE = "squeeze"
    SQZ4 = "sqz4"


class Engine(str, enum.Enum):
    ORACLE = "oracle"
    NATIVE = "native"
    TORCH = "torch"


def _todo(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to the torch engine yet "
        f"(ROADMAP.md, Queue 1 item {item})")


def _check_engine(engine):
    """Only the device engine is served; the host engines raise."""
    engine = Engine(engine)
    if engine is not Engine.TORCH:
        raise NotImplementedError(
            f"engine {engine.value!r} is not served by the port yet "
            f"(ROADMAP.md, Queue 1 item 14: host engines behind the port's "
            f"API)")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def compress(data: bytes, fmt: Format | str = Format.SQZ4,
             engine: Engine | str = Engine.TORCH,
             win_bits: int = 15, lz: bool = True,
             blocks: bool = True, blk_bits: int = 16,
             checksum: bool = True, warm: "bool | str" = False,
             parse: str = "auto", anchor_beam: int = 4,
             device="cuda") -> bytes:
    """See ``sqz_tpu.api.compress``. Codes an sqz4 sqzt container
    (``blocks=True``, ``blk_bits`` <= 16) on ``device``; ``parse`` 'exact'
    gives the reference native engine's bytes."""
    fmt = Format(fmt)
    _check_engine(engine)
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
               engine: Engine | str = Engine.TORCH,
               device="cuda") -> bytes:
    """See ``sqz_tpu.api.decompress``. Decodes a cold sqz4 sqzt container
    on ``device``; a corrupt block raises ValueError naming it."""
    _check_engine(engine)
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
