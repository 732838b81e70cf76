"""sqz4 kernel wrappers and the whole-buffer device encode and decode.

``encode_full`` and ``decode`` launch the CUDA kernels (``csrc/``) for
tensors on a CUDA device and run the plain versions (``sqz4_ref``) for
tensors on the CPU; any other device raises. Each counts its kernel
launches in its ``launches`` attribute.

``encode_data_full`` and ``decode_groups`` are the main path around them:
the native host planner -> op streams -> encoder kernel -> payloads, and
payloads -> decoder kernel -> token records -> native host assembly.
Every block of a call goes in one launch (blocks ride lanes of
``[groups, rows, lanes]`` arrays, as in the reference).
"""

from __future__ import annotations

import time

import torch

from sqz_tpu_torch import convert
from sqz_tpu_torch.ops import sqz4_host as host
from sqz_tpu_torch.ops import sqz4_ref

# Blocks (one per thread) per CTA. One spreads a call's serial chains over
# every SM with no divergence inside a warp; it measured fastest (PERF.md).
THREADS = 1


def _kernel_device(*tensors) -> torch.device:
    """The tensors' common device, if the plain version or the kernel
    serves it; the kernel's inputs must be contiguous."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("kernel inputs lie on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no sqz4 kernel for device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")
    return dev


def _check(t, name, dtype, ndim=3):
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")


def _zeros(shape, dtype, dev):
    z = torch.zeros(shape, dtype=torch.int32, device=dev)
    return z.view(torch.uint32) if dtype == torch.uint32 else z


def _check_blk_bits(blk_bits: int):
    if blk_bits > 16:
        # the device model totals stay below 2^17 only up to 64 KiB blocks
        raise ValueError("sqz4 device kernels support blk_bits <= 16")


def _launched(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def encode_full(m_ops: torch.Tensor, s_ops: torch.Tensor, cap_words: int):
    """sqz4 encoder: m_ops / s_ops uint32 [G, T/4, B] (four big-endian u8
    micro-ops a word: 0 flag, 1 size, 2 byte, 3 bits, 4..35 distance bit,
    254 flush, others pad) -> (payload words uint32 [G, cap_words, B],
    big-endian bytes; lens int32 [G, 8, B], row 0 the byte length)."""
    _check(m_ops, "m_ops", torch.uint32)
    _check(s_ops, "s_ops", torch.uint32)
    if m_ops.shape != s_ops.shape:
        raise ValueError("m_ops and s_ops differ in shape")
    dev = _kernel_device(m_ops, s_ops)
    if dev.type == "cpu":
        return sqz4_ref.encode_full_ref(m_ops, s_ops, cap_words)
    from sqz_tpu_torch.ops import _build
    G, TW, B = m_ops.shape
    words = _zeros((G, cap_words, B), torch.uint32, dev)
    lens = _zeros((G, 8, B), torch.int32, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.library().sqz4_encode_launch(
            m_ops.data_ptr(), s_ops.data_ptr(), G, TW, B, words.data_ptr(),
            cap_words, lens.data_ptr(), THREADS, stream)
    _launched(rc, "sqz4_encode")
    encode_full.launches += 1
    return words, lens


encode_full.launches = 0


def decode(payload: torch.Tensor, meta: torch.Tensor, t_max: int, lw: int,
           tw: int, mw: int):
    """sqz4 decoder: payload uint32 [G, Pw, B] (big-endian bytes), meta
    int32 [G, 8, B] (row 1 block sizes, row 2 dictionary length) ->
    (lit uint32 [G, lw, B], tok uint32 [G, tw, B], mrec uint32 [G, mw, B],
    counts int32 [G, 8, B]: optr, nlit, ntok, nmatch, err, steps, ovf,
    state)."""
    _check(payload, "payload", torch.uint32)
    _check(meta, "meta", torch.int32)
    if meta.shape[0] != payload.shape[0] or meta.shape[2] != payload.shape[2]\
            or meta.shape[1] < 3:
        raise ValueError("meta must be [G, 8, B] beside payload [G, Pw, B]")
    dev = _kernel_device(payload, meta)
    if dev.type == "cpu":
        return sqz4_ref.decode_ref(payload, meta, t_max, lw, tw, mw)
    from sqz_tpu_torch.ops import _build
    G, PW, B = payload.shape
    lit = _zeros((G, lw, B), torch.uint32, dev)
    tok = _zeros((G, tw, B), torch.uint32, dev)
    mrec = _zeros((G, mw, B), torch.uint32, dev)
    counts = _zeros((G, 8, B), torch.int32, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.library().sqz4_decode_launch(
            payload.data_ptr(), meta.data_ptr(), G, PW, B, t_max,
            lit.data_ptr(), lw, tok.data_ptr(), tw, mrec.data_ptr(), mw,
            counts.data_ptr(), THREADS, stream)
    _launched(rc, "sqz4_decode")
    decode.launches += 1
    return lit, tok, mrec, counts


decode.launches = 0


def pack_ops_words(x8: torch.Tensor) -> torch.Tensor:
    """Op-stream relayout: [G, B, R] uint8 (one contiguous row per block,
    as ``native.sqz4_fast_plan`` emits them) -> the kernel's [G, R/4, B]
    uint32 layout, four big-endian ops a word."""
    G, B, R = x8.shape
    x = x8.to(torch.int64).reshape(G, B, R // 4, 4)
    w = (x[..., 0] << 24) | (x[..., 1] << 16) | (x[..., 2] << 8) | x[..., 3]
    return sqz4_ref.to_u32(w.transpose(1, 2).contiguous())


class _Stages:
    """Host wall time per stage into ``stats`` (seconds, accumulated)."""

    def __init__(self, stats, dev):
        self.stats = stats if stats is not None else {}
        self.dev = dev
        self.t = time.perf_counter()

    def mark(self, name: str):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.stats[name] = self.stats.get(name, 0.0) + now - self.t
        self.t = now


def encode_data_full(data: bytes, blk_bits: int, window: int, lz: bool,
                     cap: int, parse: str = "auto", device="cuda",
                     lanes: int = host.LANES, stats: dict = None):
    """Whole-buffer encode -> one payload per 2^blk_bits block.

    ``parse`` 'exact' plans with ``native.sqz4_plan_pack`` (payloads equal
    the native engine's); 'fast' (the 'auto' default, SQZ_PARSE overrides)
    with ``native.sqz4_fast_plan`` plus the device relayout. ``stats``
    (optional dict) accumulates the stage times plan_s, upload_s,
    kernel_s and fetch_s."""
    from sqz_tpu import native
    _check_blk_bits(blk_bits)
    if not native.available():
        raise RuntimeError(f"native planner unavailable: "
                           f"{native.build_error()}")
    dev = torch.device(device)
    parse = host.parse_mode(parse)
    bs = 1 << blk_bits
    nb = max(1, -(-len(data) // bs))
    tp_cap = host.op_stream_cap(blk_bits)
    st = _Stages(stats, dev)
    if parse == "fast":
        m8, s8, mx = native.sqz4_fast_plan(data, window, blk_bits, lz,
                                           tp_cap)
        rows = -(-int(mx) // 4)
        st.mark("plan_s")
        m_u8, s_u8 = convert.fast_plan_inputs(m8, s8, lanes, rows, dev)
        m_ops, s_ops = pack_ops_words(m_u8), pack_ops_words(s_u8)
    else:
        mw, sw, mx = native.sqz4_plan_pack(data, window, blk_bits, lz,
                                           lanes, tp_cap)
        rows = -(-int(mx) // 4)
        st.mark("plan_s")
        m_ops, s_ops = convert.encoder_inputs(mw, sw, rows, dev)
    st.mark("upload_s")
    cap_words = host.cap_words_for(cap)
    words, lens = encode_full(m_ops, s_ops, cap_words)
    lens = convert.to_numpy(lens)
    st.mark("kernel_s")
    if int(lens[:, 0].max(initial=0)) > cap_words * 4:
        raise ValueError("compressed block exceeded the output capacity")
    words = convert.to_numpy(words[:, :host.trimmed_rows(lens)])
    payloads = host.unpack_group_payloads(words, lens, nb)
    st.mark("fetch_s")
    return payloads


def fetch_decode_host(lit, tok, mrec, counts):
    """Download one decode call's record streams trimmed to the rows the
    counts say are used, transposed on the device to [G, lanes, rows]."""
    cnt = convert.to_numpy(counts)

    def rows(used, t):
        return max(1, min(t.shape[1], int(used)))

    def lane_major(t, r):
        return convert.to_numpy(t[:, :r, :].transpose(1, 2))

    lr = rows((cnt[:, 1].max(initial=0) + 3) // 4, lit)
    tr = rows((cnt[:, 2].max(initial=0) + 31) // 32, tok)
    mr = rows(cnt[:, 3].max(initial=0), mrec)
    return (lane_major(lit, lr), lane_major(tok, tr), lane_major(mrec, mr),
            cnt)


def decode_groups(payloads, sizes, blk_bits: int, device="cuda",
                  lanes: int = host.LANES, block_ids=None,
                  stats: dict = None):
    """Payload byte strings + original sizes -> decoded blocks.

    Raises ValueError naming the caller's block index (``block_ids``,
    default positions) for a corrupt block. Payloads too long for the
    decoder buffer decode on the host codec. ``stats`` (optional dict)
    accumulates pack_s, upload_s, kernel_s, fetch_s and assemble_s."""
    _check_blk_bits(blk_bits)
    nb = len(payloads)
    if nb == 0:
        return []
    dev = torch.device(device)
    ids = list(block_ids) if block_ids is not None else list(range(nb))
    cap = 4 * host.plan_decode_dispatch(nb, blk_bits, lanes)["Pw"]
    outs = [None] * nb
    order = [b for b in range(nb) if len(payloads[b]) <= cap]
    for b in set(range(nb)) - set(order):
        outs[b] = host.host_decode(payloads[b], sizes[b])
    if not order:
        return outs
    plan = host.plan_decode_dispatch(len(order), blk_bits, lanes)
    pls = [payloads[b] for b in order]
    szs = [sizes[b] for b in order]
    # only the rows the longest payload fills are packed and uploaded: the
    # decoder reads bytes past its buffer as zeros, as it does the padding
    pw = min(plan["Pw"], host.payload_rows(max(map(len, pls))))
    st = _Stages(stats, dev)
    buf, meta = host.pack_decode_chunk(pls, szs, lanes, plan["G"], pw)
    st.mark("pack_s")
    payload_t, meta_t = convert.decoder_inputs(buf, meta, dev)
    st.mark("upload_s")
    res = decode(payload_t, meta_t, plan["t_max"], plan["lw"], plan["tw"],
                 plan["mw"])
    st.mark("kernel_s")
    lt, tt, mt, cnt = fetch_decode_host(*res)
    st.mark("fetch_s")
    dec = host.postprocess_decode(lt, tt, mt, cnt, pls, szs,
                                  1 << blk_bits,
                                  block_ids=[ids[b] for b in order],
                                  transposed=True)
    st.mark("assemble_s")
    for pos, b in enumerate(order):
        outs[b] = dec[pos]
    return outs
