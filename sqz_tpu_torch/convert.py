"""Carry the reference's kernel inputs across to the port's tensors.

The codec has no parameters: what the JAX package and the port share are
the numpy arrays its host planners and packers produce, in the kernels'
``[groups, rows, lanes]`` layout. These helpers turn them into torch
tensors on a given device, keeping dtype and layout (u32 arrays become
``torch.uint32``, i32 stay ``torch.int32``), so one source can feed the
reference kernel and the port's kernel alike.
"""

from __future__ import annotations

import numpy as np
import torch


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A contiguous copy of a u8 / i32 / u32 array on ``device``. u32 rides
    as i32 bits through the copy (torch's uint32 has few kernels)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        return torch.from_numpy(arr.view(np.int32)).to(device).view(
            torch.uint32)
    if arr.dtype not in (np.uint8, np.int32):
        raise TypeError(f"unsupported kernel input dtype {arr.dtype}")
    return torch.from_numpy(arr).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of to_device: a host numpy array of the same dtype."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).contiguous().cpu().numpy().view(np.uint32)
    return t.contiguous().cpu().numpy()


def encoder_inputs(m_words: np.ndarray, s_words: np.ndarray, rows: int,
                   device):
    """Op-stream words from ``native.sqz4_plan_pack`` ([G, tp_cap/4, lanes]
    u32) -> the first ``rows`` rows as uint32 tensors on ``device``."""
    return (to_device(m_words[:, :rows], device),
            to_device(s_words[:, :rows], device))


def fast_plan_inputs(m8: np.ndarray, s8: np.ndarray, lanes: int, rows: int,
                     device):
    """Fast-plan rows from ``native.sqz4_fast_plan`` ([nblocks, tp_cap] u8,
    one contiguous op row per block) -> [G, lanes, rows * 4] uint8 tensors
    on ``device``, padded to whole groups with pad ops (model 255)."""
    nb = m8.shape[0]
    g = -(-nb // lanes)
    mp = np.full((g * lanes, rows * 4), 255, np.uint8)
    sp = np.zeros((g * lanes, rows * 4), np.uint8)
    mp[:nb] = m8[:, :rows * 4]
    sp[:nb] = s8[:, :rows * 4]
    return (to_device(mp.reshape(g, lanes, rows * 4), device),
            to_device(sp.reshape(g, lanes, rows * 4), device))


def decoder_inputs(buf: np.ndarray, meta: np.ndarray, device):
    """``pack_decode_chunk`` output ([G, Pw, lanes] u32 payload words,
    [G, 8, lanes] i32 meta) -> (uint32, int32) tensors on ``device``."""
    return to_device(buf, device), to_device(meta, device)
