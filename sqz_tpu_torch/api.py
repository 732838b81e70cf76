"""Public API of the port: compress / decompress with the reference's
signatures (``sqz_tpu.api``) plus an explicit ``device``.

The one engine served is ``torch``, the default, on ``sqzt`` containers
of both formats, cold, warm (``warm=True``, sqzt v2) and anchored
(``warm="anchors"``, sqzt v3), coded by the CUDA kernels on
``device="cuda"`` (the default; without a card it raises) or by their
plain PyTorch versions on ``device="cpu"`` (for tests). sqz4 blocks above
64 KiB (``blk_bits`` 17..40) take the native host codec
(``ops/engine.py``); the v3 planner runs on the host, and its containers
decode on the card.

The resident paths (``compress_resident`` / ``decompress_resident``) code
data that already sits on the card (a uint8 CUDA tensor) with no host
planning, and restore it into a tensor there.

Not served yet (each raises NotImplementedError naming its ROADMAP item):
the host engines ``native`` and ``oracle``, and the resident paths over a
``mesh``.
"""

from __future__ import annotations

import enum
import os
from typing import Optional

import torch

from sqz_tpu_torch.formats import container as sqzt
from sqz_tpu_torch.formats.anchors import plan_anchored
from sqz_tpu_torch.formats.constants import (SQZT_FORMAT_SQUEEZE,
                                             SQZT_FORMAT_SQZ4,
                                             warm_dictionary, warm_gate_mask)
from sqz_tpu_torch.ops.launch import resolve_device


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


def _block_encoder(fmt: Format, win_bits: int, lz: bool, parse: str):
    """Per-block payload encoder ``(part, seed, dictionary, want_state) ->
    payload | (payload, state)`` on the port's native host codec."""
    from sqz_tpu_torch import native

    def encode_one(part, seed, dictionary, want_state):
        if fmt is Format.SQUEEZE:
            return native.squeeze_compress_payload(
                part, win_bits, seed=seed, return_state=want_state,
                dictionary=dictionary, parse=parse)
        return native.sqz4_compress_payload(
            part, 1 << win_bits, lz=lz, seed=seed, return_state=want_state,
            dictionary=dictionary, parse=parse)
    return encode_one


def _compress_anchored(parts, fmt: Format, win_bits: int, lz: bool,
                       beam: int, parse: str):
    """sqzt v3 (FORMAT.md §3.2): (payloads, fresh_mask, anchor_mask) from
    the anchor planner (``formats/anchors.plan_anchored``, a beam of
    ``beam``) on the native per-block encoder, as the reference's device
    engine plans them (sqz_tpu/api.py _compress_anchored): 'auto' parses
    fast (SQZ_PARSE overrides; sqz4 without LZ exact); beams are priced
    by encoding each block's first SQZ_ANCHOR_PRICE_PREFIX bytes (default
    4096; 0 prices whole blocks), and only the chosen variant of each
    block is coded in full."""
    from sqz_tpu_torch.ops.sqz4_host import parse_mode
    use_parse = parse_mode(parse)
    if fmt is Format.SQZ4 and not lz:
        use_parse = "exact"   # the fast matcher codes LZ parses only
    encode_one = _block_encoder(fmt, win_bits, lz, use_parse)
    pfx = int(os.environ.get("SQZ_ANCHOR_PRICE_PREFIX", str(4096)))
    price_one = None
    if pfx > 0 and max(len(p) for p in parts) > pfx:
        def price_one(p, seed, dictionary):
            return len(encode_one(p[:pfx], seed, dictionary, False))
    return plan_anchored(parts, encode_one,
                         lambda blk: warm_dictionary(blk, win_bits),
                         beam=beam,
                         gate_of=lambda d: warm_gate_mask(parts, d),
                         price_one=price_one)


def compress(data: bytes, fmt: Format | str = Format.SQZ4,
             engine: Engine | str = Engine.TORCH,
             win_bits: int = 15, lz: bool = True,
             blocks: bool = True, blk_bits: int = 16,
             checksum: bool = True, warm: "bool | str" = False,
             parse: str = "auto", anchor_beam: int = 4,
             device="cuda") -> bytes:
    """See ``sqz_tpu.api.compress``. Codes an sqzt container
    (``blocks=True``) on ``device``, cold, ``warm=True`` (sqzt v2) or
    ``warm="anchors"`` (sqzt v3, planned on the host with a beam of
    ``anchor_beam``). sqz4 at ``blk_bits`` above 16 takes the native host
    codec with the exact parse. ``parse`` 'exact' gives the reference
    native engine's bytes."""
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
    warm = warm if len(parts) > 1 else False
    dev = resolve_device(device)
    code = SQZT_FORMAT_SQUEEZE if fmt is Format.SQUEEZE else SQZT_FORMAT_SQZ4
    anchor_mask = None
    if warm == "anchors":
        payloads, fresh_mask, anchor_mask = _compress_anchored(
            parts, fmt, win_bits, lz, anchor_beam, parse)
    else:
        from sqz_tpu_torch.ops import engine as torch_engine
        res = torch_engine.compress_blocks(parts, code, win_bits, lz,
                                           blk_bits, warm=warm, parse=parse,
                                           device=dev)
        payloads, fresh_mask = res if warm else (res, None)
    csum = sqzt.fnv1a64(data) if checksum else None
    return sqzt.pack(code, win_bits, blk_bits, len(data), payloads, csum,
                     warm=bool(warm), fresh_mask=fresh_mask,
                     anchor_mask=anchor_mask)


def decompress(blob: bytes, fmt: Optional[Format | str] = None,
               engine: Engine | str = Engine.TORCH,
               device="cuda") -> bytes:
    """See ``sqz_tpu.api.decompress``. Decodes an sqzt container on
    ``device``, cold, warm (sqzt v2) or anchored (sqzt v3); a corrupt sqz4
    block raises ValueError naming it (one whose decode seeds others, on
    the host codec, OSError)."""
    _check_engine(engine)
    if blob[:8] != sqzt.SQZT_MAGIC:
        raise ValueError("torch engine requires an sqzt container")
    code, win_bits, blk_bits, osize, payloads, csum, fresh, anch = \
        sqzt.unpack(blob)
    dev = resolve_device(device)
    from sqz_tpu_torch.ops import engine as torch_engine
    bs = 1 << blk_bits
    sizes = [max(0, min(bs, osize - i * bs)) for i in range(len(payloads))]
    data = torch_engine.decompress_blocks(payloads, sizes, code, blk_bits,
                                          fresh_mask=fresh,
                                          win_bits=win_bits,
                                          anchor_mask=anch, device=dev)
    if csum is not None and sqzt.fnv1a64(data) != csum:
        raise ValueError("sqzt checksum mismatch (EILSEQ)")
    return data


def compress_resident(data, blk_bits: int = 16, mode: str = "rle",
                      checksum: bool = False, mesh=None, lanes: int = None,
                      device="cuda") -> bytes:
    """See ``sqz_tpu.api.compress_resident``: ``data`` (bytes, or a uint8
    tensor, best one already on the card) -> a cold sqz4 ``sqzt``
    container, parsed and coded on ``device`` with no host planning
    (``ops/resident.py``): ``mode`` 'lit' (literals only), 'rle' (the
    cell parse) or 'lz' (the device LZ matcher, ``ops/lzparse.py``).
    Only the payload bytes come back from the card; ``checksum`` hashes
    the input on the host (a download for a tensor), so it is off by
    default. ``lanes``: blocks per kernel launch (default 512)."""
    if mesh is not None:
        raise _todo("compress_resident over a mesh", 11)
    if not 1 <= blk_bits <= 16:
        raise ValueError("resident paths support blk_bits 1..16 "
                         "(the sqz4 device kernels' range)")
    dev = resolve_device(device)
    from sqz_tpu_torch.ops import resident
    payloads = resident.encode_resident_blocks(data, blk_bits, mode,
                                               lanes=lanes, device=dev)
    if isinstance(data, torch.Tensor):
        osize = int(data.numel())
        raw = (data.reshape(-1).cpu().numpy().tobytes() if checksum
               else None)
    else:
        raw = bytes(data)
        osize = len(raw)
    csum = sqzt.fnv1a64(raw) if checksum else None
    return sqzt.pack(SQZT_FORMAT_SQZ4, 15, blk_bits, osize, payloads, csum)


def decompress_resident(blob: bytes, mesh=None, lanes: int = None,
                        assembly: str = "auto", device="cuda"):
    """See ``sqz_tpu.api.decompress_resident``: a cold sqz4 ``sqzt``
    container -> a 1-D ``torch.uint8`` tensor on ``device``, decoded and
    assembled there (``ops/resident.py``): ``assembly`` 'cell', 'general'
    (``ops/lz_restore.py``) or 'auto' (cell, then general for the lanes
    the cell model rejects); only kernel-flagged or oversized blocks
    decode on the host. The container checksum is not verified (it would
    download the bytes): use ``decompress`` for a verified read. Warm,
    anchored and squeeze containers raise ValueError."""
    if mesh is not None:
        raise _todo("decompress_resident over a mesh", 11)
    from sqz_tpu_torch.ops import resident
    return resident.decompress_resident(blob, lanes=lanes,
                                        assembly=assembly, device=device)


__all__ = ["Engine", "Format", "compress", "decompress",
           "compress_resident", "decompress_resident"]
