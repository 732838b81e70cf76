"""The squeeze bit-packer's wrapper and the whole-buffer squeeze encode.

Counterpart of the squeeze section of ``sqz_tpu/ops/sqz4_pallas.py``
(``_bitpack_pallas``, ``squeeze_encode_data``). ``bitpack`` launches the
CUDA kernel (``csrc/squeeze_bitpack.cu``) for tensors on a CUDA device and
runs the plain version (``squeeze_ref``) for tensors on the CPU; any other
device raises. It counts its kernel launches in ``bitpack.launches``.

``squeeze_encode_data`` is the main path around it: the native host
planner runs every block's adaptive-Huffman encode and records its
bitstream writes, the records of all groups go up in one upload, one
launch packs them, and the payloads come back trimmed to the longest.
"""

from __future__ import annotations

import numpy as np
import torch

from sqz_tpu_torch import convert, native
from sqz_tpu_torch.ops import sqz4_host as host
from sqz_tpu_torch.ops import launch, squeeze_ref
from sqz_tpu_torch.ops.sqz4_cuda import fast_depth

# Lanes (one per thread) per CTA: a warp's record loads and word stores
# then touch 32 adjacent columns.
THREADS = 32
# Record rows are planned and uploaded in multiples of this (the
# reference's row chunk).
ROW_CHUNK = 512


def bitpack(ops: torch.Tensor, cap_words: int):
    """squeeze bit-packer: ops uint32 [G, T, B] write records (bit count
    ``w >> 25``, 0 a pad; the bit-reversed value in the low 25 bits) ->
    (payload words uint32 [G, cap_words, B], big-endian bytes; lens int32
    [G, 8, B], row 0 the byte length ceil(bits / 64) * 8)."""
    launch.check_tensor(ops, "ops", torch.uint32)
    dev = launch.kernel_device(ops)
    if dev.type == "cpu":
        return squeeze_ref.bitpack_ref(ops, cap_words)
    from sqz_tpu_torch.ops import _build
    G, T, B = ops.shape
    words = launch.zeros((G, cap_words, B), torch.uint32, dev)
    lens = launch.zeros((G, 8, B), torch.int32, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.library().squeeze_bitpack_launch(
            ops.data_ptr(), G, T, B, words.data_ptr(), cap_words,
            lens.data_ptr(), THREADS, stream)
    launch.launched(rc, "squeeze_bitpack")
    bitpack.launches += 1
    return words, lens


bitpack.launches = 0


def record_cap(blk_bits: int) -> int:
    """Write records a block may plan into: at most ~4 a byte (a literal's
    tree-path chunk, NYT escape and raw byte; a few a match) plus the EOS
    margin, in whole row chunks (sqz4_pallas.py:1629-1631)."""
    return -(-(4 * (1 << blk_bits) + 64) // ROW_CHUNK) * ROW_CHUNK


def upload_rows(words: np.ndarray, rows: int, device) -> torch.Tensor:
    """The first ``rows`` record rows of the planner's [G, tw_cap, lanes]
    array as a uint32 tensor on ``device``. Only those rows are copied,
    into one contiguous host buffer (pinned for a card, so the upload is
    one DMA), never the whole planner buffer, whose untouched pages stay
    unmapped."""
    dev = torch.device(device)
    G, _, lanes = words.shape
    buf = torch.empty((G, rows, lanes), dtype=torch.int32,
                      pin_memory=dev.type == "cuda")
    buf.numpy()[...] = words[:, :rows].view(np.int32)
    return buf.to(dev, non_blocking=True).view(torch.uint32)


def squeeze_encode_data(data: bytes, blk_bits: int, win_bits: int, cap: int,
                        warm: bool = False, parse: str = "auto",
                        device="cuda", stats: dict = None):
    """Whole-buffer squeeze encode -> one payload per 2^blk_bits block.

    The native planner (threaded) codes each block and records its
    writes; every group is packed in one launch. ``warm``: sqzt v2 (the
    planner seeds blocks 1+ from block 0's trees and tail dictionary; the
    packer holds no state). ``parse`` 'exact' gives the native engine's
    payloads; 'fast' (the 'auto' default, SQZ_PARSE overrides) the bounded
    matcher's (SQZ_FAST_DEPTH links). ``stats`` (optional dict)
    accumulates the stage times plan_s, upload_s, kernel_s and fetch_s."""
    dev = torch.device(device)
    parse = host.parse_mode(parse)
    nb = max(1, -(-len(data) // (1 << blk_bits)))
    st = launch.Stages(stats, dev)
    words, mx = native.squeeze_plan_pack(
        data, win_bits, blk_bits, host.LANES, record_cap(blk_bits),
        warm=warm, parse=parse, depth=fast_depth())
    rows = max(-(-int(mx) // ROW_CHUNK) * ROW_CHUNK, ROW_CHUNK)
    st.mark("plan_s")
    ops = upload_rows(words, rows, dev)
    del words
    st.mark("upload_s")
    cap_words = host.cap_words_for(cap)
    out, lens = bitpack(ops, cap_words)
    lens = convert.to_numpy(lens)
    st.mark("kernel_s")
    if int(lens[:, 0].max(initial=0)) > cap_words * 4:
        raise ValueError("compressed block exceeded the output capacity")
    out = convert.to_numpy(out[:, :host.trimmed_rows(lens)])
    payloads = host.unpack_group_payloads(out, lens, nb)
    st.mark("fetch_s")
    return payloads
