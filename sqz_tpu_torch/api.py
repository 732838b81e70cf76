"""Public API of the port: compress / decompress / decompress_range with
the reference's signatures (``sqz_tpu.api``) plus an explicit ``device``.

Engines:
  * ``torch`` (the default): ``sqzt`` containers of both formats, cold,
    warm (``warm=True``, sqzt v2) and anchored (``warm="anchors"``, sqzt
    v3), coded by the CUDA kernels on ``device="cuda"`` (the default;
    without a card it raises) or by their plain PyTorch versions on
    ``device="cpu"`` (for tests). sqz4 blocks above 64 KiB (``blk_bits``
    17..40) take the route above 64 KiB blocks on the card, the
    reference's scan route (the exact parse and the model statistics,
    the stats-fed encoder, the decoder; ``ops/engine.py``); the v3
    planner runs on the host, and its containers decode on the card.
  * ``native``: the port's copy of the C++ host runtime (``native/``),
    block-parallel on the host's cores.
  * ``oracle``: the port's copy of the scalar pure-Python codecs
    (``oracle/``), slow, the ground truth.

The host engines also code the raw single-stream reference formats
(``blocks=False``) and serve ``decompress_range``; ``device`` does not
apply to them. Their ``parse="auto"`` is the exact parse (the oracle's
is always exact), the torch engine's the fast one; ``SQZ_PARSE``
overrides both.

The resident paths (``compress_resident`` / ``decompress_resident``) code
data that already sits on the card (a uint8 CUDA tensor) with no host
planning, and restore it into a tensor there; over a ``mesh``
(``parallel/mesh.make_mesh``) every shard codes or restores its own
blocks (``parallel/shard.py``).
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
from sqz_tpu_torch.ops.launch import CONTAINER, resolve_device
from sqz_tpu_torch.ops.sqz4_host import parse_mode


class Format(str, enum.Enum):
    SQUEEZE = "squeeze"
    SQZ4 = "sqz4"


class Engine(str, enum.Enum):
    ORACLE = "oracle"
    NATIVE = "native"
    TORCH = "torch"


def _host_parse(parse: str, engine: Engine) -> str:
    """The parse of the host planners and codecs (``sqz_tpu/api.py``'s
    ``_host_parse``): 'auto' is fast on the torch engine (its sqzt
    contract is round trip and ratio), exact on the host engines (their
    containers equal across engines); SQZ_PARSE overrides
    (``sqz4_host.parse_mode``)."""
    if parse == "auto" and engine is not Engine.TORCH:
        parse = "exact"
    return parse_mode(parse)


def _block_encoder(fmt: Format, engine: Engine, win_bits: int, lz: bool,
                   parse: str):
    """Per-block payload encoder ``(part, seed, dictionary, want_state) ->
    payload | (payload, state)`` on a host engine (the native copy's
    states are flat arrays, the oracle's its own state objects)."""
    if engine is Engine.ORACLE:
        from sqz_tpu_torch.oracle.bitstream import BitWriter
        from sqz_tpu_torch.oracle.squeeze import squeeze_encode_payload
        from sqz_tpu_torch.oracle.sqz4 import sqz4_encode_payload

        def encode_one(part, seed, dictionary, want_state):
            if fmt is Format.SQZ4:
                return sqz4_encode_payload(part, 1 << win_bits, lz=lz,
                                           seed=seed,
                                           return_state=want_state,
                                           dictionary=dictionary)
            bw = BitWriter()
            st = squeeze_encode_payload(part, win_bits, bw, seed=seed,
                                        return_state=want_state,
                                        dictionary=dictionary)
            return (bw.getvalue(), st) if want_state else bw.getvalue()
        return encode_one
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
                       beam: int, parse: str, engine: Engine = Engine.TORCH):
    """sqzt v3 (FORMAT.md §3.2): (payloads, fresh_mask, anchor_mask) from
    the anchor planner (``formats/anchors.plan_anchored``, a beam of
    ``beam``) on a host engine's per-block encoder, as the reference plans
    them (sqz_tpu/api.py _compress_anchored): the torch engine's plan runs
    on the native copy, the host engines' on themselves; the fast parse
    is native-only (sqz4 without LZ is exact). Beams are priced by
    encoding each block's first SQZ_ANCHOR_PRICE_PREFIX bytes (default
    4096; 0 prices whole blocks), and only the chosen variant of each
    block is coded in full."""
    enc_engine = Engine.NATIVE if engine is Engine.TORCH else engine
    use_parse = _host_parse(parse, engine)
    if enc_engine is Engine.ORACLE or (fmt is Format.SQZ4 and not lz):
        use_parse = "exact"
    encode_one = _block_encoder(fmt, enc_engine, win_bits, lz, use_parse)
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


def _compress_host_blocks(parts, fmt: Format, engine: Engine, win_bits: int,
                          lz: bool, warm: bool, blk_bits: int, parse: str):
    """A host engine's cold payloads, or warm (payloads, fresh_mask) (sqzt
    v2: each gate candidate block 1+ coded fresh and seeded from block 0's
    final state, the smaller kept). The native copy's threaded executor
    runs the whole schedule; the oracle runs it block by block."""
    host_parse = _host_parse(parse, engine)
    if engine is Engine.ORACLE or (fmt is Format.SQZ4 and not lz):
        host_parse = "exact"   # the fast matcher is native-only
    if engine is Engine.NATIVE:
        from sqz_tpu_torch import native
        code = SQZT_FORMAT_SQUEEZE if fmt is Format.SQUEEZE \
            else SQZT_FORMAT_SQZ4
        return native.blocks_compress(b"".join(parts), code, win_bits,
                                      blk_bits, lz=lz, warm=warm,
                                      parse=host_parse)
    encode_one = _block_encoder(fmt, engine, win_bits, lz, host_parse)
    gate = [False] * len(parts)
    if warm:
        gate = warm_gate_mask(parts, warm_dictionary(parts[0], win_bits))
    fresh_mask = [True] + [False] * (len(parts) - 1)
    seed, dictionary, out = None, b"", []
    for i, p in enumerate(parts):
        want_state = warm and i == 0
        r = encode_one(p, None, b"", want_state)
        if want_state:
            r, seed = r
            dictionary = warm_dictionary(p, win_bits)
        if warm and i > 0:
            w = encode_one(p, seed, dictionary, False) if gate[i] else None
            if w is not None and len(w) < len(r):
                r = w
            else:
                fresh_mask[i] = True
        out.append(r)
    return (out, fresh_mask) if warm else out


def compress(data: bytes, fmt: Format | str = Format.SQZ4,
             engine: Engine | str = Engine.TORCH,
             win_bits: int = 15, lz: bool = True,
             blocks: bool = True, blk_bits: int = 16,
             checksum: bool = True, warm: "bool | str" = False,
             parse: str = "auto", anchor_beam: int = 4,
             device="cuda") -> bytes:
    """See ``sqz_tpu.api.compress``. ``blocks=True`` codes an sqzt
    container, cold, ``warm=True`` (sqzt v2) or ``warm="anchors"`` (sqzt
    v3, planned on the host with a beam of ``anchor_beam``): on
    ``device`` with the torch engine (sqz4 at ``blk_bits`` above 16 takes
    the stats-fed route with the exact parse), on the host with
    ``native`` or ``oracle``. ``blocks=False`` (host engines only) codes a
    raw reference stream, always with the exact parse. ``parse`` 'exact'
    gives the reference native engine's bytes on every engine."""
    fmt, engine = Format(fmt), Engine(engine)
    if not 10 <= win_bits <= 15:
        raise ValueError(f"win_bits {win_bits} outside 10..15")
    if warm not in (False, True, "anchors"):
        raise ValueError(f"warm must be bool or 'anchors', got {warm!r}")
    if blocks and not 1 <= blk_bits <= 40:
        raise ValueError(f"blk_bits {blk_bits} outside 1..40")
    if not blocks and parse not in (None, "auto"):
        raise ValueError("parse applies to sqzt containers (blocks=True); "
                         "raw reference streams are always exact-parse "
                         "(FORMAT.md §1.5)")
    if not blocks:
        if warm:
            raise ValueError("warm start requires blocks=True (sqzt "
                             "container)")
        if engine is Engine.TORCH:
            raise ValueError("torch engine requires blocks=True (sqzt "
                             "container)")
        return _compress_raw(data, fmt, engine, win_bits, lz)
    with CONTAINER.stage("split"):
        parts = sqzt.split_blocks(data, blk_bits)
    warm = warm if len(parts) > 1 else False
    code = SQZT_FORMAT_SQUEEZE if fmt is Format.SQUEEZE else SQZT_FORMAT_SQZ4
    dev = resolve_device(device) if engine is Engine.TORCH else None
    anchor_mask = None
    if warm == "anchors":
        payloads, fresh_mask, anchor_mask = _compress_anchored(
            parts, fmt, win_bits, lz, anchor_beam, parse, engine)
    else:
        if engine is Engine.TORCH:
            from sqz_tpu_torch.ops import engine as torch_engine
            res = torch_engine.compress_blocks(parts, code, win_bits, lz,
                                               blk_bits, warm=warm,
                                               parse=parse, device=dev)
        else:
            res = _compress_host_blocks(parts, fmt, engine, win_bits, lz,
                                        bool(warm), blk_bits, parse)
        payloads, fresh_mask = res if warm else (res, None)
    with CONTAINER.stage("checksum"):
        csum = sqzt.fnv1a64(data) if checksum else None
    with CONTAINER.stage("pack"):
        return sqzt.pack(code, win_bits, blk_bits, len(data), payloads,
                         csum, warm=bool(warm), fresh_mask=fresh_mask,
                         anchor_mask=anchor_mask)


def _compress_raw(data: bytes, fmt: Format, engine: Engine, win_bits: int,
                  lz: bool) -> bytes:
    """A raw single-stream reference container on a host engine."""
    if engine is Engine.ORACLE:
        from sqz_tpu_torch import oracle
        if fmt is Format.SQUEEZE:
            return oracle.squeeze_compress(data, win_bits)
        return oracle.sqz4_compress(data, window=1 << win_bits, lz=lz)
    from sqz_tpu_torch import native
    if fmt is Format.SQUEEZE:
        return native.squeeze_compress(data, win_bits)
    return native.sqz4_compress(data, window=1 << win_bits, lz=lz)


def _block_sizes(osize: int, blk_bits: int, nblocks: int):
    bs = 1 << blk_bits
    return [max(0, min(bs, osize - i * bs)) for i in range(nblocks)]


def _decode_one(payload: bytes, size: int, fmt: Format, engine: Engine,
                seed=None, return_state: bool = False,
                dictionary: bytes = b""):
    """One block payload on a host engine -> its bytes (and, with
    ``return_state``, the final state the blocks anchored on it start
    from)."""
    if engine is Engine.ORACLE:
        if fmt is Format.SQUEEZE:
            from sqz_tpu_torch.oracle.bitstream import BitReader
            from sqz_tpu_torch.oracle.squeeze import squeeze_decode_payload
            return squeeze_decode_payload(BitReader(payload), size,
                                          seed=seed,
                                          return_state=return_state,
                                          dictionary=dictionary)
        from sqz_tpu_torch.oracle.sqz4 import sqz4_decode_payload
        return sqz4_decode_payload(payload, size, seed=seed,
                                   return_state=return_state,
                                   dictionary=dictionary)
    from sqz_tpu_torch import native
    decode = (native.squeeze_decompress_payload if fmt is Format.SQUEEZE
              else native.sqz4_decompress_payload)
    return decode(payload, size, seed=seed, return_state=return_state,
                  dictionary=dictionary)


def _decompress_anchored(payloads, sizes, fmt: Format, engine: Engine,
                         win_bits: int, fresh, anch) -> bytes:
    """Warm-container decode on a host engine, v2 and v3 alike (FORMAT.md
    §3.1-3.2): fresh blocks decode cold first (keeping the state of every
    block used as an anchor), then warm blocks decode off their
    anchors."""
    anchors = sqzt.resolve_anchors(fresh, anch)
    needed = {a for a in anchors if a is not None}
    outs = [None] * len(payloads)
    states = {}
    for b in range(len(payloads)):                 # pass 1: fresh blocks
        if fresh[b]:
            if b in needed:
                outs[b], seed = _decode_one(payloads[b], sizes[b], fmt,
                                            engine, return_state=True)
                states[b] = (seed, warm_dictionary(outs[b], win_bits))
            else:
                outs[b] = _decode_one(payloads[b], sizes[b], fmt, engine)
    for b, a in enumerate(anchors):                # pass 2: warm blocks
        if a is not None:
            seed, dictionary = states[a]
            outs[b] = _decode_one(payloads[b], sizes[b], fmt, engine,
                                  seed=seed, dictionary=dictionary)
    return b"".join(outs)


def decompress(blob: bytes, fmt: Optional[Format | str] = None,
               engine: Engine | str = Engine.TORCH,
               device="cuda") -> bytes:
    """See ``sqz_tpu.api.decompress``. An sqzt container, cold, warm (sqzt
    v2) or anchored (sqzt v3), decodes on ``device`` with the torch engine
    (a corrupt sqz4 block raises ValueError naming it; one whose decode
    seeds others, on the host codec, OSError) or on the host with
    ``native`` / ``oracle``; a raw reference stream (``fmt`` taken from
    its magic when None) only on a host engine."""
    engine = Engine(engine)
    if blob[:8] != sqzt.SQZT_MAGIC:
        if engine is Engine.TORCH:
            raise ValueError("torch engine requires an sqzt container")
        return _decompress_raw(blob, fmt, engine)
    with CONTAINER.stage("unpack"):
        code, win_bits, blk_bits, osize, payloads, csum, fresh, anch = \
            sqzt.unpack(blob)
        sizes = _block_sizes(osize, blk_bits, len(payloads))
    fmt = Format.SQUEEZE if code == SQZT_FORMAT_SQUEEZE else Format.SQZ4
    if engine is Engine.TORCH:
        dev = resolve_device(device)
        from sqz_tpu_torch.ops import engine as torch_engine
        data = torch_engine.decompress_blocks(payloads, sizes, code,
                                              blk_bits, fresh_mask=fresh,
                                              win_bits=win_bits,
                                              anchor_mask=anch, device=dev)
    elif engine is Engine.NATIVE and anch is None:
        # the threaded executor runs the cold batch and the v2 (block-0
        # anchor) schedule itself; v3 takes the anchored schedule below
        from sqz_tpu_torch import native
        data = native.blocks_decompress(list(payloads), osize, code,
                                        blk_bits, fresh_mask=fresh,
                                        win_bits=win_bits)
    elif fresh is not None:
        data = _decompress_anchored(payloads, sizes, fmt, engine, win_bits,
                                    fresh, anch)
    else:
        data = b"".join(_decode_one(p, n, fmt, engine)
                        for p, n in zip(payloads, sizes))
    with CONTAINER.stage("checksum"):
        if csum is not None and sqzt.fnv1a64(data) != csum:
            raise ValueError("sqzt checksum mismatch (EILSEQ)")
    return data


def _decompress_raw(blob: bytes, fmt, engine: Engine) -> bytes:
    """A raw single-stream reference container on a host engine."""
    if fmt is None:
        fmt = Format.SQZ4 if blob[:8] == b"squeeze4" else Format.SQUEEZE
    fmt = Format(fmt)
    if engine is Engine.ORACLE:
        from sqz_tpu_torch import oracle
        if fmt is Format.SQUEEZE:
            return oracle.squeeze_decompress(blob)
        return oracle.sqz4_decompress(blob)
    from sqz_tpu_torch import native
    if fmt is Format.SQUEEZE:
        return native.squeeze_decompress(blob)
    return native.sqz4_decompress(blob)


def decompress_range(blob: bytes, start: int, length: int,
                     engine: Engine | str = Engine.NATIVE) -> bytes:
    """See ``sqz_tpu.api.decompress_range``: random-access decode of
    ``[start, start + length)`` from an ``sqzt`` container on a host
    engine. Only the covering blocks decode, plus once each anchor a warm
    block among them starts from (block 0 in v2). The container checksum
    covers the whole payload and is not verified here: an undetected
    corruption of an anchor's payload can change the bytes of the warm
    blocks read off it, so verify the container once with
    ``decompress`` where that matters."""
    engine = Engine(engine)
    if engine is Engine.TORCH:
        raise ValueError("decompress_range is a host feature; "
                         "use engine='native' or 'oracle'")
    if blob[:8] != sqzt.SQZT_MAGIC:
        raise ValueError("decompress_range requires an sqzt container")
    code, win_bits, blk_bits, osize, payloads, _csum, fresh, anch = \
        sqzt.unpack(blob)
    fmt = Format.SQUEEZE if code == SQZT_FORMAT_SQUEEZE else Format.SQZ4
    if start < 0 or length < 0 or start + length > osize:
        raise ValueError(f"range [{start}, {start + length}) outside "
                         f"[0, {osize})")
    if length == 0:
        return b""
    sizes = _block_sizes(osize, blk_bits, len(payloads))
    b_lo = start >> blk_bits
    b_hi = (start + length - 1) >> blk_bits
    anchors = (sqzt.resolve_anchors(fresh, anch) if fresh is not None
               else [None] * len(payloads))
    needed = {anchors[b] for b in range(b_lo, b_hi + 1)
              if anchors[b] is not None}
    states, decoded = {}, {}
    for a in sorted(needed):
        decoded[a], seed = _decode_one(payloads[a], sizes[a], fmt, engine,
                                       return_state=True)
        states[a] = (seed, warm_dictionary(decoded[a], win_bits))
    out = bytearray()
    for b in range(b_lo, b_hi + 1):
        if b in decoded:
            out += decoded[b]
        elif anchors[b] is not None:
            seed, dictionary = states[anchors[b]]
            out += _decode_one(payloads[b], sizes[b], fmt, engine,
                               seed=seed, dictionary=dictionary)
        else:
            out += _decode_one(payloads[b], sizes[b], fmt, engine)
    off = start - (b_lo << blk_bits)
    return bytes(out[off:off + length])


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
    default. ``lanes``: blocks a lane group (default 512); 'lit' and
    'rle' hand the kernel ``resident.LAUNCH_GROUPS`` groups a launch.

    ``mesh`` (a ``parallel.mesh.Mesh``): blocks shard over its devices
    and every shard parses and codes its own blocks
    (``parallel/shard.encode_resident_sharded``); ``device`` does not
    apply. In a multi-process mesh only rank 0 receives the container
    (None elsewhere)."""
    from sqz_tpu_torch.ops import resident
    resident.check_resident_blk_bits(blk_bits)
    if mesh is not None:
        from sqz_tpu_torch.parallel.shard import encode_resident_sharded
        payloads = encode_resident_sharded(data, blk_bits, mesh, mode,
                                           lanes)
        if payloads is None:                # not rank 0 of the mesh
            return None
    else:
        payloads = resident.encode_resident_blocks(
            data, blk_bits, mode, lanes=lanes, device=resolve_device(device))
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
    anchored and squeeze containers raise ValueError.

    ``mesh``: every shard restores its own blocks
    (``parallel/shard.decompress_resident_sharded``, ``assembly`` kept),
    into one tensor on the mesh's first local device, on every rank;
    ``device`` does not apply."""
    if mesh is not None:
        from sqz_tpu_torch.parallel.shard import decompress_resident_sharded
        return decompress_resident_sharded(blob, mesh, lanes, assembly)
    from sqz_tpu_torch.ops import resident
    return resident.decompress_resident(blob, lanes=lanes,
                                        assembly=assembly, device=device)


__all__ = ["Engine", "Format", "compress", "decompress",
           "decompress_range", "compress_resident", "decompress_resident"]
