"""The device LZ matcher of the resident path (``compress_resident(mode=
"lz")``), the port of ``sqz_tpu/ops/lzparse.py``: raw blocks on the card
-> the token streams the token encoder's lit_skip mode codes over the raw
blocks, by tensor ops (sorts, scans, gathers), no host work.

1. Candidates by sort: for grams of k = 4, 8, 16 bytes, a stable sort of
   each block's positions by gram (the 4-byte gram itself as the key,
   else a mixed 32-bit hash of the gram's words) puts equal grams side by
   side in position order, so each position's nearest earlier occurrence
   is its left neighbour, kept only if the gram's words are equal (a hash
   collision loses a candidate, never makes one).
2. Extension by agreement: the same distance at p + 1 proves one more
   equal byte, so a log-doubling run length over the agreement mask gives
   exact match lengths; the nearest of the tables chains the same way.
3. Parse: segments of S = 256 bytes parse independently, a cursor walk
   over the in-segment offsets (matches clip at the segment's end; length
   >= 4, or >= 2 at distance <= 7; one-step lazy: a strictly longer match
   at the next byte defers this one).
4. Tokens: matches at their starts, literal runs split at 255, EOS at the
   block length, compacted by a sort on position. A block with more
   tokens than its slots demotes to the literal-only parse.

Only the reference's defaults are ported: grams (4, 8, 16), whole-row
sorts (``seg=0``), the words ride the sort (``verify="carry"``). Its
environment knobs (SQZ_LZ_GRAMS, SQZ_LZ_SORT_ROWS, SQZ_LZ_SORT_SEG,
SQZ_LZ_VERIFY) and its 64-row slicing worked around the TPU sort's
compile times; the tokens are the same.
"""

from __future__ import annotations

import torch

from sqz_tpu_torch.ops import launch, sqz4_cuda, sqz4_host as host
from sqz_tpu_torch.ops.resident import (EOS_TOKEN, SPANS, _round_up,
                                        _tokens_from_lengths, bit_length,
                                        in_groups)
from sqz_tpu_torch.ops.sqz4_ref import M32, to_u32

I64 = torch.int64
GRAM_SIZES = (4, 8, 16)
SEG = 256                 # parse segment (matches clip at its end)
WIN_MASK = (1 << 15) - 1  # format max distance (sqz_max_win_bits)
MAX_LEN = 254             # format max match length (sqz_max_len)


def _signed32(x):
    """int64 holding u32 bits -> the int32 value of those bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x)


def _shift_left(x, j: int):
    """x[:, j:] padded with j zeros at the end."""
    return torch.nn.functional.pad(x[:, j:], (0, j)) if j else x


def _gram_words(blocks, k: int):
    """[B, n] u8 -> ceil(k/4) [B, n] int64 words (int32 values): the bytes
    at p..p+k, big-endian, zeros past the end."""
    x = blocks.to(I64)
    words = []
    for w in range(-(-k // 4)):
        v = torch.zeros_like(x)
        for j in range(4 * w, min(4 * w + 4, k)):
            v = (v << 8) | _shift_left(x, j)
        words.append(_signed32(v))
    return words


def _gram_hash(words):
    """The gram's words mixed into one int32 sort key (a u32 multiply-xor
    hash, read as signed)."""
    h = torch.zeros_like(words[0])
    for w in words:
        h = ((h ^ (w & M32)) * 0x9E3779B1) & M32
        h = h ^ (h >> 15)
    return _signed32(h)


def _table_dists(blocks, lengths, k: int):
    """Per position, the distance to the nearest earlier occurrence of its
    k-gram (0: none; both grams inside the block's length, the distance
    within the window)."""
    words = _gram_words(blocks, k)
    key = words[0] if len(words) == 1 else _gram_hash(words)
    order = torch.sort(key, dim=1, stable=True).indices   # sorted positions
    same = torch.ones_like(order, dtype=torch.bool)
    for w in words:
        sw = w.gather(1, order)
        same = same & torch.nn.functional.pad(sw[:, 1:] == sw[:, :-1],
                                              (1, 0))
    sv = order + k <= lengths[:, None]
    prev_pos = torch.nn.functional.pad(order[:, :-1], (1, 0), value=-1)
    prev_ok = torch.nn.functional.pad(sv[:, :-1], (1, 0))
    d = torch.where(same & prev_ok & sv, order - prev_pos,
                    torch.zeros_like(order))
    d = torch.where((d > 0) & (d <= WIN_MASK), d, torch.zeros_like(d))
    return torch.zeros_like(d).scatter_(1, order, d)      # position order


def _runlen(agree, cap: int):
    """Consecutive True runs starting at each position (log doubling)."""
    rl = agree.to(I64)
    s = 1
    while s < cap:
        rl = torch.where(rl == s, s + _shift_left(rl, s), rl)
        s *= 2
    return rl.clamp(max=cap)


def _select_stage(lengths, dists):
    """The gram tables -> the best (ml, dist) per position: each table's
    chained run and the nearest-of-the-tables chain, the longest (then
    the nearest) winning."""
    n = dists[0].shape[1]
    pos = torch.arange(n, dtype=I64, device=lengths.device)[None, :]
    rem = (lengths[:, None] - pos).clamp(min=0)
    m = torch.zeros_like(dists[0])
    for dd in dists:
        m = torch.where((dd > 0) & ((m == 0) | (dd < m)), dd, m)
    ml = torch.zeros_like(m)
    dist = torch.zeros_like(m)
    for base, dd in list(zip(GRAM_SIZES, dists)) + [(GRAM_SIZES[0], m)]:
        v = dd > 0
        agree = torch.nn.functional.pad(
            v[:, :-1] & v[:, 1:] & (dd[:, 1:] == dd[:, :-1]), (0, 1))
        rl = _runlen(agree, MAX_LEN - base)
        mlt = torch.minimum(torch.where(v, base + rl, torch.zeros_like(rl)),
                            rem.clamp(max=MAX_LEN))
        take = v & ((mlt > ml) | ((mlt == ml) & (dd < dist)))
        ml = torch.where(take, mlt, ml)
        dist = torch.where(take, dd, dist)
    return ml, dist


def _greedy_flags(ml, dist):
    """The segment-greedy cursor walk over the SEG in-segment offsets ->
    the [B, n] match-start mask."""
    B, n = ml.shape
    S = SEG
    ml_r = ml.reshape(B, n // S, S)
    d_r = dist.reshape(B, n // S, S)
    cur = torch.zeros_like(ml_r[:, :, 0])
    flags = torch.zeros_like(ml_r, dtype=torch.bool)
    for t in range(S):
        active = cur == t
        mlt = ml_r[:, :, t].clamp(max=S - t)
        dt = d_r[:, :, t]
        minl = torch.where(dt <= 7, 2, 4)
        ok = active & (dt > 0) & (mlt >= minl)
        if t + 1 < S:
            nl = ml_r[:, :, t + 1].clamp(max=S - t - 1)
            ok = ok & ~((d_r[:, :, t + 1] > 0) & (nl > mlt))
        cur = torch.where(ok, t + mlt, torch.where(active, cur + 1, cur))
        flags[:, :, t] = ok
    return flags.reshape(B, n)


def _tokens_from_flags(mstart, ml, dist, lengths, Tt: int):
    """Match starts -> ([B, Tt] int64 token rows, token counts, op-pair
    counts). Literal runs split at 255; a match costs max(ceil(len / 32),
    coding) pairs under lit_skip, a literal one, EOS and flushes 5."""
    B, n = mstart.shape
    dev = mstart.device
    pos = torch.arange(n, dtype=I64, device=dev)[None, :].expand(B, n)
    L = lengths[:, None]
    zero = torch.zeros_like(pos)
    mlen = torch.where(mstart, torch.minimum(ml, (pos // SEG + 1) * SEG - pos),
                       zero)
    # covered: inside a match (spans never overlap: the cursor jumped)
    run_end = torch.where(mstart, pos + mlen, zero - 1).cummax(1).values
    lit = (pos < L) & ~(pos < run_end) & ~mstart
    rstart0 = lit & ~torch.nn.functional.pad(lit[:, :-1], (1, 0))
    srt = torch.where(rstart0, pos, zero - 1).cummax(1).values
    rstart = lit & ((pos - srt) % 255 == 0)
    # run length: to the next non-literal position
    nxt = torch.where(lit, zero + n + 1, pos).flip(1).cummin(1).values.flip(1)
    rlen = torch.minimum(
        torch.where(rstart, nxt - pos, zero).clamp(max=255), L - pos)
    nb = bit_length(dist)
    mtok = mlen | (1 << 8) | (nb << 9) | (dist << 16)
    tok = torch.where(mstart, mtok, torch.where(rstart, rlen, zero))
    istok = mstart | rstart
    key = torch.cat([torch.where(istok, pos, zero + n + 2), L], 1)
    tok = torch.cat([tok, torch.full_like(L, EOS_TOKEN)], 1)
    # keys are unique but for the non-tokens' (all tok 0): any sort works
    toks = tok.gather(1, torch.sort(key, dim=1, stable=True).indices)[:, :Tt]
    ntok = istok.sum(1) + 1
    coding = 2 + torch.where(nb > 2, (nb - 1) // 2, zero)
    mpairs = torch.maximum((mlen + 31) // 32,
                           torch.where(mstart, coding, zero))
    pairs = (lit.to(I64) + torch.where(mstart, mpairs, zero)).sum(1) + 5
    return toks, ntok, pairs


def _parse_stage(ml, dist, lengths, Tt: int):
    """Cursor walk, token compaction and the slot-budget demotion: blocks
    with more than Tt tokens re-parse literal-only (always fits)."""
    mstart = _greedy_flags(ml, dist)
    toks, ntok, pairs = _tokens_from_flags(mstart, ml, dist, lengths, Tt)
    demote = ntok > Tt
    toks = torch.where(demote[:, None], _tokens_from_lengths(lengths, Tt),
                       toks)
    pairs = torch.where(demote, lengths + 5, pairs)
    return toks, pairs, demote


def lz_plan_device(blocks, lengths, Tt: int):
    """The device parse of raw [B, bs] u8 blocks with valid lengths [B]
    -> (uint32 tokens [1, B, Tt], int64 pair counts [B], demoted-to-
    literal mask [B]). The raw blocks are the literal rows."""
    lengths = lengths.to(I64)
    dists = [_table_dists(blocks, lengths, k) for k in GRAM_SIZES]
    ml, dist = _select_stage(lengths, dists)
    del dists
    toks, pairs, demote = _parse_stage(ml, dist, lengths, Tt)
    return to_u32(toks)[None].contiguous(), pairs, demote


def lz_group_args(blk_bits: int) -> dict:
    """Sizes of an LZ-mode encode group: token slots a quarter of the
    block (a min-length-4 parse can approach it), at most 2^14."""
    bs = 1 << blk_bits
    return dict(Tt=max(96, min(_round_up(bs // 4 + 64, 32), 1 << 14)),
                cap_words=host.cap_words_for(bs + 2048))


def encode_lz_group(blocks, lengths, Tt: int, cap_words: int,
                    st: launch.Stages = SPANS, groups: int = 1):
    """``groups`` lane groups through the device parse and one launch of
    the lit_skip token kernel over the raw blocks -> (words, lens); the
    pair budget is the longest lane's count (one int read back). ``st``
    times and names the stages parse and kernel."""
    with st.stage("parse"):
        toks, pairs, _dem = lz_plan_device(blocks, lengths, Tt)
        t_max = int(pairs.max())
    with st.stage("kernel"):
        return sqz4_cuda.encode_tok(in_groups(toks, groups),
                                    in_groups(blocks, groups), t_max,
                                    cap_words, lit_skip=True)
