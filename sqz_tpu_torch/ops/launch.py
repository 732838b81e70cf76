"""Launch plumbing shared by the kernel wrappers (``sqz4_cuda``,
``squeeze_cuda``) and the entry points: the requested device, input
checks, the device that picks kernel or plain version, zeroed outputs,
the launch status check and per-stage host timing."""

from __future__ import annotations

import threading
import time

import torch

_count_lock = threading.Lock()


def resolve_device(device) -> torch.device:
    """An entry point's ``device``: "cuda" (the card; RuntimeError without
    one) or "cpu" (the plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def kernel_device(*tensors) -> torch.device:
    """The tensors' common device, if the plain version or the kernel
    serves it; the kernel's inputs must be contiguous."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("kernel inputs lie on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")
    return dev


def check_tensor(t, name, dtype, ndim=3):
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")


def zeros(shape, dtype, dev):
    """A zeroed int32 or uint32 tensor (uint32 as a view of int32)."""
    z = torch.zeros(shape, dtype=torch.int32, device=dev)
    return z.view(torch.uint32) if dtype == torch.uint32 else z


def launched(rc: int, name: str):
    """Raise unless the launcher returned CUDA success (0)."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def count(wrapper, attr: str = "launches"):
    """Add one launch to ``wrapper.<attr>``, under a lock: a mesh's
    shards on distinct devices launch from a host thread each."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


class Stages:
    """Host wall time per stage into ``stats`` (seconds, accumulated;
    nothing is kept or waited for when ``stats`` is None). A mark waits
    for the caller's current stream only, so a mesh's shards on other
    streams of the device run on."""

    def __init__(self, stats, dev):
        self.stats = stats
        self.dev = dev
        self.t = time.perf_counter()

    def mark(self, name: str):
        if self.stats is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.current_stream(self.dev).synchronize()
        now = time.perf_counter()
        self.stats[name] = self.stats.get(name, 0.0) + now - self.t
        self.t = now
