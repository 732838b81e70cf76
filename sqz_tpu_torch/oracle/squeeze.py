"""``squeeze`` format codec — scalar oracle (FORMAT.md §1).

Pinned to reference attic/map_experiment/squeeze.h: LZ77 (window <= 32 KiB,
lengths 3..257) + two adaptive Huffman trees with NYT escapes + DEFLATE-like
base/extra-bit tables over the LSB-first bitstream.
"""

from __future__ import annotations

from sqz_tpu_torch.formats.constants import (
    LEN_BASE, LEN_XB, POS_BASE, POS_XB,
    build_len_index, build_pos_index,
    SQUEEZE_MIN_WIN_BITS, SQUEEZE_MAX_WIN_BITS,
    SQUEEZE_LEN_MIN, SQUEEZE_LEN_MAX,
    SQUEEZE_SYM_MIN, SQUEEZE_LIT_NYT, SQUEEZE_POS_NYT,
    SQUEEZE_LIT_TERMINALS, SQUEEZE_POS_TERMINALS,
)
from sqz_tpu_torch.oracle.bitstream import BitReader, BitWriter
from sqz_tpu_torch.oracle.huffman import AdaptiveHuffman
from sqz_tpu_torch.oracle.match import greedy_tokens

_LEN_INDEX = build_len_index()
_POS_INDEX = build_pos_index()


def _new_trees(seed=None):
    """Fresh NYT-seeded trees, or trees restored from a ``TreeSeed``
    (sqzt v2 warm start, FORMAT.md §3.1)."""
    lit = AdaptiveHuffman(SQUEEZE_LIT_TERMINALS)
    pos = AdaptiveHuffman(SQUEEZE_POS_TERMINALS)
    if seed is not None:
        lit.load(seed.lit)
        pos.load(seed.pos)
        return lit, pos
    # both sides seed the NYT leaves before the first token (squeeze.h:333-334)
    lit.insert(SQUEEZE_LIT_NYT)
    pos.insert(SQUEEZE_POS_NYT)
    return lit, pos


class TreeSeed:
    """Engine-portable snapshot of the two adaptive-Huffman trees (the
    squeeze analog of sqz4's ModelSeed). Unlike sqz4 there is no rescale:
    the host tree walkers have no numeric range constraint, and the device
    squeeze encoder consumes host-planned bit words."""

    def __init__(self, lit, pos) -> None:
        self.lit = list(map(int, lit))
        self.pos = list(map(int, pos))

    @classmethod
    def capture(cls, lit: AdaptiveHuffman, pos: AdaptiveHuffman) -> "TreeSeed":
        return cls(lit.snapshot(), pos.snapshot())


def tree_seed_from_tokens(tokens) -> TreeSeed:
    """Replay a token stream's tree updates without writing bits — block 0's
    final tree state for warm blocks 1+ (sqzt v2, FORMAT.md §3.1). Update
    order matches the encoder exactly: known symbol -> inc_frequency(sym);
    unseen -> inc_frequency(NYT) then insert(sym) (squeeze.h:239-246,
    278-315)."""
    lit, pos = _new_trees()

    def bump(tree, nyt, sym):
        if tree.pix[sym] == -1:
            tree.inc_frequency(nyt)
            tree.insert(sym)
        else:
            tree.inc_frequency(sym)

    for tok in tokens:
        if tok[0] == "lit":
            bump(lit, SQUEEZE_LIT_NYT, tok[1])
        else:
            _, length, dist = tok
            bump(lit, SQUEEZE_LIT_NYT, SQUEEZE_SYM_MIN + int(_LEN_INDEX[length]))
            bump(pos, SQUEEZE_POS_NYT, int(_POS_INDEX[dist]))
    return TreeSeed.capture(lit, pos)


def _write_huffman(bw: BitWriter, tree: AdaptiveHuffman, sym: int) -> None:
    # path first, tree update strictly after (squeeze.h:239-246)
    bw.write_bits(tree.path[sym], tree.bits[sym])
    tree.inc_frequency(sym)


def _encode_lit_symbol(bw: BitWriter, lit: AdaptiveHuffman, sym: int) -> None:
    if lit.pix[sym] == -1:  # unseen: NYT escape + 9 raw bits (squeeze.h:278-288)
        _write_huffman(bw, lit, SQUEEZE_LIT_NYT)
        bw.write_bits(sym, 9)
        lit.insert(sym)
    else:
        _write_huffman(bw, lit, sym)


def _encode_pos_symbol(bw: BitWriter, pos: AdaptiveHuffman, code: int) -> None:
    if pos.pix[code] == -1:  # unseen: NYT escape + 5 raw bits (squeeze.h:300-315)
        _write_huffman(bw, pos, SQUEEZE_POS_NYT)
        bw.write_bits(code, 5)
        pos.insert(code)
    else:
        _write_huffman(bw, pos, code)


def squeeze_encode_payload(data: bytes, win_bits: int, bw: BitWriter,
                           seed: "TreeSeed | None" = None,
                           return_state: bool = False,
                           dictionary: bytes = b""):
    """Token payload only (no header) — shared with the sqzt container.
    ``seed``/``return_state``/``dictionary``: sqzt v2 warm start
    (FORMAT.md §3.1)."""
    lit, pos = _new_trees(seed)
    tokens = greedy_tokens(data, 1 << win_bits, SQUEEZE_LEN_MIN,
                           SQUEEZE_LEN_MAX, dictionary=dictionary)
    for tok in tokens:
        if tok[0] == "lit":
            _encode_lit_symbol(bw, lit, tok[1])
        else:
            _, length, dist = tok
            li = int(_LEN_INDEX[length])
            _encode_lit_symbol(bw, lit, SQUEEZE_SYM_MIN + li)
            if LEN_XB[li]:
                bw.write_bits(length - int(LEN_BASE[li]), int(LEN_XB[li]))
            pi = int(_POS_INDEX[dist])
            _encode_pos_symbol(bw, pos, pi)
            if POS_XB[pi]:
                bw.write_bits(dist - int(POS_BASE[pi]), int(POS_XB[pi]))
    bw.flush()
    if return_state:
        return TreeSeed.capture(lit, pos)
    return None


def squeeze_compress(data: bytes, win_bits: int = 15) -> bytes:
    if not (SQUEEZE_MIN_WIN_BITS <= win_bits <= SQUEEZE_MAX_WIN_BITS):
        raise ValueError(f"win_bits {win_bits} outside 10..15")
    bw = BitWriter()
    bw.write_bits(len(data), 64)   # header (squeeze.h:255-265)
    bw.write_bits(win_bits, 8)
    squeeze_encode_payload(data, win_bits, bw)
    return bw.getvalue()


def _read_huffman(br: BitReader, tree: AdaptiveHuffman) -> int:
    i = tree.m - 1  # root (squeeze.h:429-442)
    bit = br.read_bit()
    while True:
        i = tree.rix[i] if bit else tree.lix[i]
        if i < 0:  # corrupt path into a missing child (EILSEQ)
            raise ValueError("corrupt Huffman path (EILSEQ)")
        if tree.lix[i] < 0 and tree.rix[i] < 0:
            break
        bit = br.read_bit()
    tree.inc_frequency(i)
    return i


def squeeze_decode_payload(br: BitReader, size: int,
                           seed: "TreeSeed | None" = None,
                           return_state: bool = False,
                           dictionary: bytes = b""):
    lit, pos = _new_trees(seed)
    out = bytearray(dictionary)
    dlen = len(out)
    size += dlen  # produce past the preset-history prefix
    while len(out) < size:
        sym = _read_huffman(br, lit)
        if sym == SQUEEZE_LIT_NYT:
            sym = br.read_bits(9)
            if lit.pix[sym] != -1:   # escape of a present symbol: malformed
                raise ValueError("NYT escape names a present symbol (EILSEQ)")
            if not lit.insert(sym):
                raise ValueError("lit tree pool exhausted")
        if sym <= 0xFF:
            out.append(sym)
        else:
            if not (SQUEEZE_SYM_MIN <= sym < SQUEEZE_LIT_NYT):
                raise ValueError(f"bad length symbol {sym}")
            li = sym - SQUEEZE_SYM_MIN
            length = int(LEN_BASE[li])
            if LEN_XB[li]:
                length += br.read_bits(int(LEN_XB[li]))
            pi = _read_huffman(br, pos)
            if pi == SQUEEZE_POS_NYT:
                pi = br.read_bits(5)
                if pos.pix[pi] != -1:
                    raise ValueError(
                        "NYT escape names a present symbol (EILSEQ)")
                if not pos.insert(pi):
                    raise ValueError("pos tree pool exhausted")
            if pi >= len(POS_BASE):
                raise ValueError(f"bad distance code {pi}")
            dist = int(POS_BASE[pi])
            if POS_XB[pi]:
                dist += br.read_bits(int(POS_XB[pi]))
            if not (0 < dist <= len(out)):
                raise ValueError(f"distance {dist} out of range at {len(out)}")
            if len(out) + length > size:
                raise ValueError("output overrun (ERANGE)")
            # overlapped copy is byte-serial by definition (squeeze.h:535-539)
            for _ in range(length):
                out.append(out[-dist])
    if return_state:
        return bytes(out[dlen:]), TreeSeed.capture(lit, pos)
    return bytes(out[dlen:])


def squeeze_decompress(blob: bytes) -> bytes:
    br = BitReader(blob)
    size = br.read_bits(64)
    win_bits = br.read_bits(8)
    if not (SQUEEZE_MIN_WIN_BITS <= win_bits <= SQUEEZE_MAX_WIN_BITS):
        raise ValueError(f"corrupt header: win_bits {win_bits}")
    return squeeze_decode_payload(br, size)
