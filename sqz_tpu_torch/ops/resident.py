"""Device-resident sqz4 encode and restore (``compress_resident`` /
``decompress_resident``), the port of ``sqz_tpu/ops/resident.py``.

The input already sits in the card's memory (checkpoint shards,
activation buffers: a ``torch.uint8`` CUDA tensor), so no host planner
runs: the token streams are computed from the raw blocks by tensor ops on
the card, the token encoder codes them, and only payload bytes come back.

- ``mode="lit"``: the reference HEAD semantics (literals only), one run
  token per 255 literals and EOS; the cold token kernel codes them with
  the raw blocks as its literal rows.
- ``mode="rle"``: a cell parse. A 128-byte cell that continues a period-d
  repeat (d a power of two up to 128) becomes one len-128 match; an
  all-zero cell copies the nearest earlier zero cell, and any other cell
  the smallest eligible earlier cell with the same fingerprint and bytes
  (cell-aligned distances). The token kernel's lit_skip mode codes them
  over the raw blocks.
- ``mode="lz"``: the general device matcher (``ops/lzparse.py``), on
  lit_skip too.

Restore: the decoder kernel gives literal, token-bit and match-record
streams; the cell assembly (``decode_rle_group``) places them for
cell-parsed streams, the general assembly (``ops/lz_restore.py``) for any
spec-valid stream, and only kernel-flagged (corrupt) or oversized lanes
reach the host codec. ``route_lanes`` counts the lanes each route
restored.

Arrays are lane-major here (``[B, ...]``, one block a row): the token
kernel takes tokens ``[G, B, Tt]`` and literal bytes ``[G, B, L]``, so
the raw blocks are its literal input as they are. u32 arithmetic runs in
int64 masked to 32 bits. Payloads, containers and restored bytes equal
the reference's.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from sqz_tpu_torch import convert, native
from sqz_tpu_torch.formats import container as sqzt
from sqz_tpu_torch.formats.constants import SQZT_FORMAT_SQZ4
from sqz_tpu_torch.ops import launch, sqz4_cuda, sqz4_host as host
from sqz_tpu_torch.ops.sqz4_ref import M32, to_u32

I64 = torch.int64
EOS_TOKEN = 0x1FF   # 0xFF | (1 << 8): match flag + len 255
CELL = 128
# candidate periods of the cell parse: smaller d wins (fewer distance-bit
# pairs, a warmer distance model)
RLE_DISTS = (1, 2, 4, 8, 16, 32, 64, 128)

# lanes (blocks) restored by each route of decompress_resident
route_lanes = {"cell": 0, "general": 0, "host": 0}
_route_lock = threading.Lock()
LZ_LANES = 512   # most blocks a device-LZ launch codes


def count_route(route: str, n: int):
    """Add ``n`` lanes to ``route_lanes[route]`` (a mesh's shards on
    distinct devices restore from a host thread each)."""
    with _route_lock:
        route_lanes[route] += n


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _token_dim(bs: int) -> int:
    # run tokens + EOS + one fetch-past-the-end slot, window-aligned
    return max(96, _round_up(-(-bs // 255) + 2, 32))


def bit_length(x):
    """bit_length of int64 values below 2^16."""
    nb = torch.zeros_like(x)
    for i in range(16):
        nb = nb + (x >= (1 << i)).to(I64)
    return nb


def _tokens_from_lengths(lengths, Tt: int):
    """[B] block lengths -> [B, Tt] int64 literal-run token rows (runs of
    255 then the remainder, EOS, zeros): native sqz4_tok_plan's lz=0
    layout."""
    t = torch.arange(Tt, dtype=I64, device=lengths.device)[None, :]
    L = lengths.to(I64)[:, None]
    runs = (L + 254) // 255
    rem = (L - t * 255).clamp(0, 255)
    tok = torch.where(t < runs, rem, torch.zeros_like(rem))
    return torch.where(t == runs, torch.full_like(tok, EOS_TOKEN), tok)


def match_token(dist):
    """Cell match tokens (len 128) at int64 distances ``dist`` (< 2^15)."""
    return CELL | (1 << 8) | (bit_length(dist) << 9) | (dist << 16)


def _cell_fingerprints(cells):
    """[B, C, CELL] u8 -> [B, C] int64: the keyed u32 wrap-around sum of
    a cell's bytes (key (i * 0x9E3779B1 + 1) mod 2^32 at byte i)."""
    kw = (torch.arange(CELL, dtype=I64, device=cells.device) * 0x9E3779B1
          + 1) & M32
    return (cells.to(I64) * kw).sum(2) & M32


def _dedup_sources(cells, eligible):
    """[B, C] int64: for each cell, the smallest EARLIER eligible cell
    with the same fingerprint (C + 1 where there is none), and whether
    its bytes equal the cell's (a fingerprint collision is no match)."""
    B, C, _ = cells.shape
    fp = _cell_fingerprints(cells)
    c_s = torch.arange(C, dtype=I64, device=cells.device)
    src = torch.empty((B, C), dtype=I64, device=cells.device)
    chunk = 64   # output cells a step: a [B, 64, C] compare
    for c0 in range(0, C, chunk):
        out_c = c_s[c0:c0 + chunk]
        ok = ((fp[:, c0:c0 + chunk, None] == fp[:, None, :])
              & eligible[:, None, :]
              & (c_s[None, None, :] < out_c[None, :, None]))
        cand = torch.where(ok, c_s[None, None, :], torch.full_like(
            c_s, C + 1)[None, None, :])
        src[:, c0:c0 + chunk] = cand.min(2).values
    got = torch.gather(cells, 1, src.clamp(max=C - 1)[:, :, None].expand(
        B, C, CELL))
    return src, (got == cells).all(2)


def _rle_tokens_from_blocks(blocks, lengths, Tt: int):
    """The cell parse of [B, bs] u8 blocks with valid ``lengths`` [B]:
    ([B, Tt] int64 token rows, [B] int64 op-pair counts), the
    reference's tokens and counts. A full cell (not the first) that
    continues a period-d repeat (bytes[i] == bytes[i - d] across it, the
    overlapped-copy semantics) is a len-128 dist-d match, the smallest d
    first; an all-zero cell without one copies the nearest earlier
    all-zero full cell (dist k * 128, k <= 255); a remaining full cell
    equal to the smallest eligible (not itself matched) earlier cell of
    its fingerprint within 255 cells copies it; other cells are 128
    literals, the partial tail a literal run, EOS last. Pairs: 128 a
    literal cell, max(4 drain, coding) a match, the tail's bytes, 5 for
    EOS and the flushes."""
    B, bs = blocks.shape
    dev = blocks.device
    C = bs // CELL
    c = torch.arange(C, dtype=I64, device=dev)[None, :]
    cells = blocks.reshape(B, C, CELL)
    cell_tok = torch.full((B, C), CELL, dtype=I64, device=dev)
    matched = torch.zeros((B, C), dtype=torch.bool, device=dev)
    first = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    for d in reversed(RLE_DISTS):                       # small d wins
        if d < CELL:
            intra = (cells[:, :, d:] == cells[:, :, :-d]).all(2)
            stitch = (cells[:, 1:, :d] == cells[:, :-1, CELL - d:]).all(2)
        else:
            intra = torch.ones((B, C), dtype=torch.bool, device=dev)
            stitch = (cells[:, 1:] == cells[:, :-1]).all(2)
        ok = intra & torch.cat([first, stitch], 1)      # never cell 0
        dd = torch.tensor(d, dtype=I64, device=dev)
        cell_tok = torch.where(ok, match_token(dd), cell_tok)
        matched = matched | ok
    L = lengths.to(I64)[:, None]
    full = (c > 0) & ((c + 1) * CELL <= L)
    # far zero-cell copies: the nearest earlier all-zero full cell
    fullsrc = (c + 1) * CELL <= L                       # cell 0 too
    iszero = fullsrc & (cells == 0).all(2)
    prevz = torch.where(iszero, c, torch.full_like(c, -1)).cummax(1).values
    prevz = torch.cat([torch.full((B, 1), -1, dtype=I64, device=dev),
                       prevz[:, :-1]], 1)               # exclusive
    k = c - prevz
    farok = iszero & ~matched & (c > 0) & (prevz >= 0) & (k <= 255)
    cell_tok = torch.where(farok, match_token(k * CELL), cell_tok)
    matched = matched | farok
    # generic dedup: the smallest eligible earlier cell of the same
    # fingerprint, if its bytes are equal; sources are never matched
    # cells, so they restore as literal cells
    dsrc, dver = _dedup_sources(cells, fullsrc & ~matched)
    kd = c - dsrc
    dupok = full & ~matched & dver & (kd >= 1) & (kd <= 255)
    ddist = torch.where(dupok, kd * CELL, torch.zeros_like(kd))
    cell_tok = torch.where(dupok, match_token(ddist), cell_tok)
    matched = matched | dupok
    isrun = matched & full
    cell_tok = torch.where(isrun, cell_tok, torch.full_like(cell_tok, CELL))
    nfull = lengths.to(I64) // CELL
    rem = lengths.to(I64) - nfull * CELL
    eslot = nfull + (rem > 0).to(I64)
    t = torch.arange(Tt, dtype=I64, device=dev)[None, :]
    ct = torch.cat([cell_tok, torch.zeros((B, Tt - C), dtype=I64,
                                          device=dev)], 1)
    tok = torch.where(t < nfull[:, None], ct, torch.zeros_like(ct))
    tok = torch.where((t == nfull[:, None]) & (rem[:, None] > 0),
                      rem[:, None].expand_as(tok), tok)
    tok = torch.where(t == eslot[:, None], torch.full_like(tok, EOS_TOKEN),
                      tok)
    nb_c = (cell_tok >> 9) & 0x1F
    coding = 2 + torch.where(nb_c > 2, (nb_c - 1) // 2,
                             torch.zeros_like(nb_c))
    cell_pairs = torch.where(isrun, coding.clamp(min=4),
                             torch.full_like(coding, CELL))
    pairs = torch.where(c < nfull[:, None], cell_pairs,
                        torch.zeros_like(cell_pairs)).sum(1) + rem + 5
    return tok, pairs


def rle_plan_device(blocks, lengths, Tt: int):
    """The cell parse on the blocks' device: (uint32 tokens [1, B, Tt],
    int64 pair counts [B]). The raw blocks are the literal rows."""
    toks, pairs = _rle_tokens_from_blocks(blocks, lengths, Tt)
    return to_u32(toks)[None].contiguous(), pairs


def encode_group_args(blk_bits: int) -> dict:
    """Sizes of a literal-only encode group at this block size."""
    bs = 1 << blk_bits
    return dict(Tt=_token_dim(bs), t_max=bs + 5,
                cap_words=host.cap_words_for(bs + 2048))


def rle_group_args(blk_bits: int) -> dict:
    """Sizes of an RLE-mode encode group (a token slot per cell, the
    tail and EOS)."""
    bs = 1 << blk_bits
    return dict(Tt=max(96, _round_up(bs // CELL + 2, 32)),
                cap_words=host.cap_words_for(bs + 2048))


def encode_literal_group(blocks, lengths, Tt: int, t_max: int,
                         cap_words: int, st=None):
    """One lane group, literal-only: raw [B, bs] u8 blocks and their
    valid lengths [B] -> (payload words uint32 [1, cap_words, B], lens
    int32 [1, 8, B]) from the cold token kernel. ``st``
    (launch.Stages) marks parse_s before the kernel."""
    toks = to_u32(_tokens_from_lengths(lengths, Tt))[None].contiguous()
    mark(st, "parse_s")
    return sqz4_cuda.encode_tok(toks, blocks[None], t_max, cap_words)


def encode_rle_group(blocks, lengths, Tt: int, cap_words: int, st=None):
    """One lane group through the cell parse and the lit_skip token
    kernel over the raw blocks; the pair budget is the longest lane's
    count (one int read back)."""
    toks, pairs = rle_plan_device(blocks, lengths, Tt)
    t_max = int(pairs.max())
    mark(st, "parse_s")
    return sqz4_cuda.encode_tok(toks, blocks[None], t_max, cap_words,
                                lit_skip=True)


def mark(st, name: str):
    """st.mark(name) when stage times are kept (st a launch.Stages)."""
    if st is not None:
        st.mark(name)


def _prep_blocks(data, blk_bits: int, lanes: int, dev):
    """bytes, a uint8 numpy array or a uint8 tensor -> ([rows, bs] u8
    blocks on ``dev``, [rows] int64 valid lengths on ``dev``, block
    count). A tensor already on ``dev`` is padded and reshaped there:
    nothing is downloaded."""
    bs = 1 << blk_bits
    if isinstance(data, torch.Tensor):
        if data.dtype != torch.uint8:
            raise ValueError(f"resident data must be uint8, got "
                             f"{data.dtype}")
        flat = data.reshape(-1).to(dev)
    else:
        if isinstance(data, np.ndarray) and data.dtype != np.uint8:
            raise ValueError(f"resident data must be uint8, got "
                             f"{data.dtype}")
        flat = torch.from_numpy(np.frombuffer(bytes(data), np.uint8)
                                .copy()).to(dev)
    n = int(flat.numel())
    nb = max(1, -(-n // bs))
    rows = max(lanes, _round_up(nb, lanes))
    blocks = torch.nn.functional.pad(flat, (0, rows * bs - n)).reshape(
        rows, bs)
    lengths = np.zeros((rows,), np.int64)
    lengths[:nb] = np.clip(n - np.arange(nb, dtype=np.int64) * bs, 0, bs)
    return blocks, torch.from_numpy(lengths).to(dev), nb


def resident_coder(blk_bits: int, mode: str, lanes: int = None):
    """The group coder of a resident encode: (coder, its sizes, blocks a
    launch). ``mode`` 'rle' takes blocks smaller than a cell and 'lz'
    blocks smaller than a parse segment literal-only; 'lz' codes at most
    LZ_LANES blocks a launch (``lanes`` default ``sqz4_host.LANES``)."""
    from sqz_tpu_torch.ops import lzparse
    if blk_bits > sqz4_cuda.DEVICE_BLK_BITS:
        raise ValueError("sqz4 device kernels support blk_bits <= 16")
    if mode not in ("lit", "rle", "lz"):
        raise ValueError(f"unknown resident mode {mode!r}")
    bs = 1 << blk_bits
    if mode == "rle" and bs < CELL:
        mode = "lit"    # blocks smaller than a cell: no matches possible
    if mode == "lz" and bs < lzparse.SEG:
        mode = "lit"    # blocks smaller than one parse segment
    lanes = lanes or host.LANES
    if mode == "lz":
        lanes = min(lanes, LZ_LANES)
    group, args = {"lit": (encode_literal_group, encode_group_args),
                   "rle": (encode_rle_group, rle_group_args),
                   "lz": (lzparse.encode_lz_group, lzparse.lz_group_args)
                   }[mode]
    return group, args(blk_bits), lanes


def encode_rows(data, blk_bits: int, coder, dev, st=None):
    """``data`` (bytes or a uint8 tensor) -> one payload per block through
    ``coder`` (``resident_coder``'s triple), a launch per group of its
    lanes, the payloads fetched group by group (compacted on the card by
    SQZ_FETCH's default)."""
    group, gargs, lanes = coder
    blocks, lengths, nb = _prep_blocks(data, blk_bits, lanes, dev)
    payloads: list = []
    for g0 in range(0, blocks.shape[0], lanes):
        words, lens = group(blocks[g0:g0 + lanes], lengths[g0:g0 + lanes],
                            st=st, **gargs)
        mark(st, "kernel_s")
        payloads += sqz4_cuda.fetch_payloads(words, lens,
                                             min(lanes, nb - g0),
                                             sqz4_cuda.fetch_mode())
        mark(st, "fetch_s")
    return payloads


def encode_resident_blocks(data, blk_bits: int, mode: str = "rle",
                           lanes: int = None, device="cuda",
                           stats: dict = None):
    """Resident encode of ``data`` (bytes or a uint8 tensor) -> one sqz4
    payload per 2^blk_bits block. ``mode`` 'lit', 'rle' or 'lz' (see the
    module); the downloads are the payload bytes and, in 'rle' and 'lz',
    one int (the pair budget). ``lanes``: blocks a launch (default 512).
    ``stats`` accumulates parse_s (blocks and tokens on the device),
    kernel_s and fetch_s."""
    dev = torch.device(device)
    return encode_rows(data, blk_bits, resident_coder(blk_bits, mode, lanes),
                       dev, launch.Stages(stats, dev))


# ------------------------------------------------- restore (cell assembly)

def _cols(t):
    """A decoder output [1, R, B] (u32 / i32) -> [B, R] int64 (u32
    values masked to 32 bits)."""
    x = t[0].view(torch.int32).to(I64)
    if t.dtype == torch.uint32:
        x = x & M32
    return x.t()


def _at(rows, idx):
    """rows [B, R] int64, idx [B] -> rows[b, idx[b]], 0 past the row (the
    reference's one-hot row read)."""
    R = rows.shape[1]
    v = rows.gather(1, idx.clamp(0, R - 1)[:, None])[:, 0]
    return torch.where(idx < R, v, torch.zeros_like(v))


def words_to_bytes(w):
    """[..., W] int64 u32 words -> [..., 4 W] int64 bytes (big-endian in
    each word, the kernels' stream layout)."""
    by = torch.stack([(w >> 24) & 0xFF, (w >> 16) & 0xFF, (w >> 8) & 0xFF,
                      w & 0xFF], -1)
    return by.reshape(*w.shape[:-1], w.shape[-1] * 4)


def _classify_cells(tokw, mrecw, sizes, C: int):
    """Pass 1: walk the cells through the decoder's token bits (tokw [B,
    TW], LSB-first, one bit a decoded token) and match records (mrecw [B,
    MW], len << 16 | dist, in match order). A cell is a match cell iff its
    first token is a match, which must be a len-128 match at a power-of-2
    dist <= 128 or a cell-aligned far dist within the block, else the
    stream is not cell-parsed (bad). Returns (ismatch [B, C], dist [B,
    C], bad [B], tokens consumed [B])."""
    B = tokw.shape[0]
    dev = tokw.device
    tcur = torch.zeros(B, dtype=I64, device=dev)
    mcur = torch.zeros_like(tcur)
    bad = torch.zeros(B, dtype=torch.bool, device=dev)
    ism = torch.zeros((B, C), dtype=torch.bool, device=dev)
    dist = torch.zeros((B, C), dtype=I64, device=dev)
    zero = torch.zeros_like(tcur)
    for c in range(C):
        remaining = (sizes - c * CELL).clamp(min=0)
        active = remaining > 0
        bit = (_at(tokw, tcur >> 5) >> (tcur & 31)) & 1
        ismatch = active & (bit == 1)
        rec = _at(mrecw, mcur)
        d = rec & 0xFFFF
        mlen = (rec >> 16) & 0xFFFF
        okd = (d > 0) & (d <= CELL) & ((d & (d - 1)) == 0)
        okfar = (d > CELL) & (d % CELL == 0) & (d <= c * CELL)
        bad = bad | (ismatch & ((mlen != CELL) | ~(okd | okfar)
                                | (remaining < CELL)))
        tcur = tcur + torch.where(ismatch, zero + 1, torch.where(
            active, remaining.clamp(max=CELL), zero))
        mcur = mcur + ismatch.to(I64)
        ism[:, c] = ismatch
        dist[:, c] = torch.where(ismatch, d, zero)
    return ism, dist, bad, tcur


def _gather_cells(cells, src, mask):
    """cells [B, C, CELL], src [B, C] -> cells[b, src[b, c]] where
    ``mask``, zeros elsewhere."""
    B, C, W = cells.shape
    got = torch.gather(cells, 1, src[:, :, None].expand(B, C, W))
    return torch.where(mask[:, :, None], got, torch.zeros_like(got))


def _preplace_literal_cells(litw, islit, C: int):
    """Pass 2: the decoder's dense literal stream (litw [B, LW] u32 words)
    placed at its output cells: literal cells come in stream order, so
    output cell c reads literal cell cumsum_excl(islit)[c]. Returns [B, C,
    CELL] u8, zeros at match cells."""
    B = litw.shape[0]
    lit_cells = words_to_bytes(litw[:, :C * 32]).reshape(B, C, CELL).to(
        torch.uint8)
    isl = islit.to(I64)
    return _gather_cells(lit_cells, isl.cumsum(1) - isl, islit)


# the periodic fill of a cell from the previous output cell at dist
# RLE_DISTS[k - 1] reads its bytes CELL - d + (j mod d); row 0 is unused
_FILL_IDX = [list(range(CELL))] + [[CELL - d + j % d for j in range(CELL)]
                                   for d in RLE_DISTS]


def _fill_cells(pre, ismatch, dist, farfill):
    """Pass 3: resolve the periodic fills cell by cell (a match cell's
    bytes derive from the previous OUTPUT cell's tail: a chain of C steps
    of [B, CELL] work); far cell-aligned dists (> CELL) take ``farfill``,
    the literal preplacement at the source cell (zeros when the source is
    not a literal cell), which decode_rle_group verifies afterwards."""
    B, C, _ = pre.shape
    dev = pre.device
    code = torch.zeros_like(dist)
    for k, d in enumerate(RLE_DISTS, 1):
        code = torch.where(dist == d, torch.full_like(code, k), code)
    periodic = ismatch & (code > 0)
    base = torch.where((ismatch & (dist > CELL))[:, :, None], farfill, pre)
    tab = torch.tensor(_FILL_IDX, dtype=I64, device=dev)
    out = torch.empty_like(pre)
    prev = torch.zeros((B, CELL), dtype=pre.dtype, device=dev)
    for c in range(C):
        prev = torch.where(periodic[:, c, None],
                           prev.gather(1, tab[code[:, c]]), base[:, c])
        out[:, c] = prev
    return out


def decoder_args(blk_bits: int, lanes: int) -> dict:
    """The decoder's sizes for a restore group (the reference's
    plan_decode_dispatch)."""
    plan = host.plan_decode_dispatch(lanes, blk_bits, lanes=lanes)
    return {k: plan[k] for k in ("Pw", "t_max", "lw", "tw", "mw")}


def run_decoder(buf, plens, sizes, dargs: dict):
    """The decoder kernel on one group: buf uint32 [1, pw, B], plens and
    sizes [B] -> (lit, tok, mrec, counts), the kernel's layouts."""
    z = torch.zeros_like(plens)
    meta = torch.stack([plens, sizes, z, z, z, z, z, z]).to(
        torch.int32)[None].contiguous()
    return sqz4_cuda.decode(buf, meta, dargs["t_max"], dargs["lw"],
                            dargs["tw"], dargs["mw"])


def assemble_cells(lit, tok, mrec, counts, sizes, bs: int):
    """The three-pass cell assembly of one decoded group: ([B, bs] u8
    blocks, [B] bad) where bad marks lanes that are not cell-parsed or
    that the kernel flagged."""
    B = sizes.shape[0]
    C = bs // CELL
    cnt = _cols(counts)
    ism, dist, bad, tcur = _classify_cells(_cols(tok), _cols(mrec), sizes, C)
    # completeness: the cell model predicts exactly ntok tokens; matches
    # not at cell starts consume fewer
    bad = bad | (tcur != cnt[:, 2])
    c_i = torch.arange(C, dtype=I64, device=sizes.device)[None, :]
    islit = (c_i * CELL < sizes[:, None]) & ~ism
    pre = _preplace_literal_cells(_cols(lit), islit, C)
    isfar = ism & (dist > CELL)
    src = (c_i - dist // CELL).clamp(0, C - 1)
    out = _fill_cells(pre, ism, dist, _gather_cells(pre, src, isfar))
    # far fills assumed the source cell restores to its literal bytes;
    # verify out[c] == out[src] (by induction over cells this makes any
    # passing stream's bytes the spec's); a mismatch goes to the host
    mism = (_gather_cells(out, src, isfar) != out).any(2)
    bad = bad | (isfar & mism).any(1)
    blocks = out.reshape(B, bs)
    pos = torch.arange(bs, device=sizes.device)[None, :]
    blocks = torch.where(pos < sizes[:, None], blocks,
                         torch.zeros_like(blocks))
    bad = bad | (cnt[:, 4] != 0) | (cnt[:, 6] != 0)
    return blocks, bad


def decode_rle_group(buf, plens, sizes, dargs: dict, bs: int, st=None):
    """Resident decode of cell-parsed sqz4 payloads: the decoder kernel,
    then the cell assembly. Returns ([B, bs] u8 blocks, counts [1, 8, B],
    bad [B]). ``st`` (launch.Stages) marks kernel_s and cell_s."""
    lit, tok, mrec, counts = run_decoder(buf, plens, sizes, dargs)
    mark(st, "kernel_s")
    blocks, bad = assemble_cells(lit, tok, mrec, counts, sizes, bs)
    mark(st, "cell_s")
    return blocks, counts, bad


def unpack_cold_container(blob: bytes):
    """A cold sqz4 sqzt container -> (blk_bits, osize, payloads, sizes);
    ValueError for any other container."""
    code, _win_bits, blk_bits, osize, payloads, _csum, fresh, _anch = \
        sqzt.unpack(blob)
    if code != SQZT_FORMAT_SQZ4 or fresh is not None:
        raise ValueError("resident decode supports cold sqz4 containers")
    bs = 1 << blk_bits
    sizes = [min(bs, osize - b * bs) for b in range(len(payloads))]
    return blk_bits, osize, payloads, sizes


def pack_payload_group(grp, gsz, Pw: int, lanes: int):
    """Payload bytes -> ([1, pw, lanes] u32 big-endian words, plens, szs,
    oversized mask), pw the rows the longest payload that fits needs (the
    decoder reads zeros past its buffer, as it reads the padding). A
    payload longer than Pw words gets an empty lane, which the decoder
    flags; the host codec decodes its real bytes."""
    n = len(grp)
    plens = np.zeros((lanes,), np.int64)
    szs = np.zeros((lanes,), np.int64)
    over = np.zeros((lanes,), bool)
    fit = []
    for i, p in enumerate(grp):
        over[i] = len(p) > 4 * Pw
        fit.append(b"" if over[i] else p)
        plens[i] = 0 if over[i] else len(p)
    szs[:n] = gsz
    pw = min(Pw, host.payload_rows(max(map(len, fit), default=0)))
    buf = native.sqz4_pack_payloads(fit, lanes, pw)[:1]
    return buf, plens, szs, over


def host_decode_blocks(payloads, sizes, idx, blocks_np):
    """The host codec (the port's native copy) decodes blocks ``idx`` into
    the writable [n, bs] array; a corrupt payload raises."""
    for i in idx:
        out = native.sqz4_decompress_payload(payloads[i], sizes[i])
        blocks_np[i, :sizes[i]] = np.frombuffer(out, np.uint8)


def decompress_resident(blob: bytes, lanes: int = None,
                        assembly: str = "auto", device="cuda",
                        stats: dict = None):
    """Restore an sqzt sqz4 container into a 1-D uint8 tensor on
    ``device``: payload bytes upload once, the decoder kernel and the
    assembly run there.

    ``assembly``: 'cell' (the cell assembly; lanes it rejects decode on
    the host), 'general' (the exact sort / scan / pointer-doubling
    assembly of ``ops/lz_restore.py``, for any spec-valid stream) or
    'auto' (cell first, then general for the lanes the cell model
    rejects, the host only for kernel-flagged or oversized lanes). The
    lanes of each route count in ``route_lanes``. ``stats`` accumulates
    pack_s, upload_s, kernel_s, cell_s, general_s and host_s."""
    check_assembly(assembly)
    blk_bits, osize, payloads, sizes = unpack_cold_container(blob)
    dev = launch.resolve_device(device)
    return restore_blocks(payloads, sizes, blk_bits, lanes or host.LANES,
                          assembly, dev, launch.Stages(stats, dev))


def check_assembly(assembly: str):
    if assembly not in ("auto", "cell", "general"):
        raise ValueError(f"unknown assembly {assembly!r}")


def restore_blocks(payloads, sizes, blk_bits: int, lanes: int,
                   assembly: str, dev, st=None):
    """Consecutive blocks of a cold sqz4 container (their payloads and
    sizes, only the last short) -> their bytes, a 1-D uint8 tensor on
    ``dev`` (``decompress_resident``'s routes, ``lanes`` blocks a
    launch)."""
    from sqz_tpu_torch.ops import lz_restore
    bs = 1 << blk_bits
    nb = len(payloads)
    total = sum(sizes)
    if blk_bits < 7:
        # blocks smaller than a cell: no cell model; tiny blocks decode on
        # the host and upload once
        out = np.zeros((nb, bs), np.uint8)
        host_decode_blocks(payloads, sizes, range(nb), out)
        count_route("host", nb)
        return torch.from_numpy(out.reshape(-1)[:total].copy()).to(dev)
    sqz4_cuda.check_blk_bits(blk_bits)
    dargs = decoder_args(blk_bits, lanes)
    outs = []
    for g0 in range(0, nb, lanes):
        grp, gsz = payloads[g0:g0 + lanes], sizes[g0:g0 + lanes]
        n = len(grp)
        buf, plens, szs, over = pack_payload_group(grp, gsz, dargs["Pw"],
                                                   lanes)
        mark(st, "pack_s")
        bufd = convert.to_device(buf, dev)
        plensd, szsd = (torch.from_numpy(a).to(dev) for a in (plens, szs))
        mark(st, "upload_s")
        if assembly == "general":
            blocks, _c, bad = lz_restore.decode_lz_group(
                bufd, plensd, szsd, dargs, bs, st=st)
        else:
            blocks, _c, bad = decode_rle_group(bufd, plensd, szsd, dargs,
                                               bs, st=st)
        bad_np = convert.to_numpy(bad)[:n] | over[:n]
        count_route("general" if assembly == "general" else "cell",
                    int((~bad_np).sum()))
        if bad_np.any() and assembly == "auto":
            # not cell-parsed: the general assembly restores it on the
            # card (one more decoder pass over the group)
            gblocks, _gc, gbad = lz_restore.decode_lz_group(
                bufd, plensd, szsd, dargs, bs, st=st)
            gbad_np = convert.to_numpy(gbad)[:n]
            sel = bad_np & ~gbad_np
            blocks = torch.where(
                torch.from_numpy(np.pad(sel, (0, lanes - n))).to(dev)[:, None],
                gblocks, blocks)
            count_route("general", int(sel.sum()))
            bad_np = bad_np & gbad_np
        if bad_np.any():
            # kernel-flagged (corrupt: the host codec raises its error) or
            # oversized lanes
            fixed = convert.to_numpy(blocks[:n]).copy()
            host_decode_blocks(grp, gsz, np.nonzero(bad_np)[0], fixed)
            blocks = torch.from_numpy(fixed).to(dev)
            count_route("host", int(bad_np.sum()))
            mark(st, "host_s")
        # only the last block can be short: flatten and trim
        outs.append(blocks[:n].reshape(-1))
    return torch.cat(outs)[:total]
