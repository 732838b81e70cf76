"""``sqz4`` format codec — scalar oracle (FORMAT.md §2).

Pinned to reference src/sqz.c:590-839: adaptive binary range coder over
per-symbol frequency models; token grammar = literal/match/EOS with
per-bit-position distance models and an implicit distance MSB.

The decoder reconstructs the implicit MSB as ``1 << (nbits-1)`` — matching
the encoder (src/sqz.c:694-698) and fixing the reference decoder's latent
off-by-one (src/sqz.c:821, unreachable at reference HEAD; see FORMAT.md §2.4).
"""

from __future__ import annotations

from sqz_tpu_torch.formats.constants import (
    SQZ4_MAGIC, SQZ4_MIN_LEN, SQZ4_MAX_LEN, SQZ4_EOS,
)
from sqz_tpu_torch.oracle.match import greedy_tokens
from sqz_tpu_torch.oracle.rangecoder import ProbModel, RangeDecoder, RangeEncoder


class _Models:
    """The 36 adaptive models of struct sqz (src/sqz.c:550-565).

    ``seed`` (sqzt v2 warm-start, FORMAT.md §3): a frequency snapshot from
    ModelSeed — blocks 1+ of a warm container start from block 0's final
    state instead of fresh freq-1 models."""

    def __init__(self, seed: "ModelSeed | None" = None) -> None:
        self.literal = ProbModel(2)
        self.size = ProbModel(256)
        self.byte = ProbModel(256)
        self.bits = ProbModel(32)
        self.dist = [ProbModel(2) for _ in range(32)]
        if seed is not None:
            seed.load_into(self)

    def snapshot(self) -> "ModelSeed":
        return ModelSeed.capture(self)


class ModelSeed:
    """Engine-portable frequency snapshot of the 36 sqz4 models.

    Flat u32 layout (shared with the native runtime and the device
    kernels): literal[2] + size[256] + byte[256] + bits[32] +
    dist0[32] + dist1[32] = 610 words.

    Capture applies the normative rescale (FORMAT.md §3.1): per model,
    while total > 2^14, every nonzero freq becomes (freq+1)>>1. The cap
    bounds warm-block model totals below 2^17 for blocks up to 64 KiB —
    the exactness range of the device kernels' wide divider — while
    keeping the frequency ratios (the modeling value) intact.
    """

    WORDS = 2 + 256 + 256 + 32 + 64
    RESCALE_LIMIT = 1 << 14

    def __init__(self, flat) -> None:
        assert len(flat) == self.WORDS
        self.flat = list(map(int, flat))

    @staticmethod
    def _rescale(freqs):
        f = list(map(int, freqs))
        while sum(f) > ModelSeed.RESCALE_LIMIT:
            f = [(v + 1) >> 1 if v else 0 for v in f]
        return f

    @classmethod
    def capture(cls, pm: "_Models") -> "ModelSeed":
        r = cls._rescale
        flat = (r(pm.literal.freq[:2]) + r(pm.size.freq[:256])
                + r(pm.byte.freq[:256]) + r(pm.bits.freq[:32]))
        dist = [cls._rescale([pm.dist[b].freq[0], pm.dist[b].freq[1]])
                for b in range(32)]
        flat += [d[0] for d in dist] + [d[1] for d in dist]
        return cls(flat)

    def load_into(self, pm: "_Models") -> None:
        f = self.flat
        pm.literal.set_freqs(f[0:2])
        pm.size.set_freqs(f[2:258])
        pm.byte.set_freqs(f[258:514])
        pm.bits.set_freqs(f[514:546])
        for b in range(32):
            pm.dist[b].set_freqs([f[546 + b], f[578 + b]])


def _reject(length: int, dist: int) -> bool:
    # short matches with far distances cost more than literals (src/sqz.c:678-685)
    return length <= 3 and dist.bit_length() > 3


def sqz4_encode_payload(data: bytes, window: int, lz: bool = True,
                        seed: ModelSeed | None = None,
                        return_state: bool = False,
                        dictionary: bytes = b"",
                        tokens=None):
    """Encode one block. ``seed`` warm-starts the models (sqzt v2);
    ``return_state`` additionally returns the final model snapshot (the
    seed for subsequent warm blocks); ``dictionary`` is the shared preset
    history warm blocks may match into (FORMAT.md §3.1). ``tokens``
    overrides the parse with a caller-supplied token sequence (e.g. the
    refmap parse, oracle/refmap.py) — tokens must be spec-valid."""
    pm = _Models(seed)
    enc = RangeEncoder()
    if tokens is not None:
        pass
    elif lz:
        tokens = greedy_tokens(data, window, SQZ4_MIN_LEN, SQZ4_MAX_LEN,
                               dictionary=dictionary,
                               reject=_reject)
    else:  # literal-only: reference HEAD behavior (src/sqz.c:591 map.n = 0)
        tokens = [("lit", b) for b in data]
    for tok in tokens:
        if tok[0] == "lit":
            enc.encode(pm.literal, 1)
            enc.encode(pm.byte, tok[1])
        else:
            _, length, dist = tok
            nbits = dist.bit_length()
            enc.encode(pm.literal, 0)
            enc.encode(pm.size, length)
            enc.encode(pm.bits, nbits)
            d = dist
            for b in range(nbits - 1):  # low bits LSB-first; MSB implicit
                enc.encode(pm.dist[b], d & 1)
                d >>= 1
    enc.encode(pm.literal, 0)   # EOS (src/sqz.c:741-742)
    enc.encode(pm.size, SQZ4_EOS)
    enc.flush()
    if return_state:
        return enc.getvalue(), pm.snapshot()
    return enc.getvalue()


def sqz4_compress(data: bytes, window: int = 1 << 15, lz: bool = True,
                  container: bool = True, parse: str = "greedy") -> bytes:
    """``parse="greedy"`` (default) uses the exact greedy matcher;
    ``parse="refmap"`` uses the reference hash-map dictionary's decisions
    (oracle/refmap.py — the map-wired src/sqz.c parse, COMPONENTS #4-5)."""
    tokens = None
    if parse == "refmap" and lz:
        from sqz_tpu_torch.oracle.refmap import refmap_tokens
        tokens = list(refmap_tokens(data, window))
    elif parse != "greedy":
        raise ValueError(f"unknown parse {parse!r}")
    payload = sqz4_encode_payload(data, window, lz=lz, tokens=tokens)
    if not container:
        return payload
    # harness container: magic + LE size (reference test.c:41-46)
    return SQZ4_MAGIC + len(data).to_bytes(8, "little") + payload


def sqz4_decode_payload(payload: bytes, size: int,
                        seed: ModelSeed | None = None,
                        return_state: bool = False,
                        dictionary: bytes = b""):
    pm = _Models(seed)
    dec = RangeDecoder(payload)
    hist = bytearray(dictionary)
    dlen = len(hist)
    out = hist  # matches may reach into the preset dictionary prefix
    while True:
        flag = dec.decode(pm.literal)
        if dec.error:
            raise ValueError(f"range coder error {dec.error}")
        if flag:
            if len(out) - dlen >= size:
                raise ValueError("output overrun (ENOBUFS)")
            out.append(dec.decode(pm.byte))
        else:
            length = dec.decode(pm.size)
            if length == SQZ4_EOS:
                break
            if not (SQZ4_MIN_LEN <= length <= SQZ4_MAX_LEN):
                raise ValueError(f"bad match length {length} (ERANGE)")
            nbits = dec.decode(pm.bits)
            dist = 0
            for b in range(nbits - 1):
                dist |= dec.decode(pm.dist[b]) << b
            if nbits > 0:
                dist |= 1 << (nbits - 1)  # implicit MSB (see module docstring)
            if dist > len(out):
                raise ValueError(f"distance {dist} out of range (ERANGE)")
            if len(out) - dlen + length > size:
                raise ValueError("output overrun (ENOBUFS)")
            for _ in range(length):  # overlapped copy is byte-serial
                out.append(out[-dist])
    res = bytes(out[dlen:])
    if return_state:
        return res, pm.snapshot()
    return res


def sqz4_decompress(blob: bytes, size: int | None = None) -> bytes:
    if size is None:  # container framing
        if blob[:8] != SQZ4_MAGIC:
            raise ValueError("bad squeeze4 magic (EILSEQ)")
        size = int.from_bytes(blob[8:16], "little")
        blob = blob[16:]
    return sqz4_decode_payload(blob, size)
