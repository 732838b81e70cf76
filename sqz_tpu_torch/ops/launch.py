"""Launch plumbing shared by the kernel wrappers (``sqz4_cuda``,
``squeeze_cuda``) and the entry points: the requested device, input
checks, the device that picks kernel or plain version, zeroed outputs,
the launch status check, and the host stages of a call (profiler
ranges and host timing)."""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _profiler

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
    """The host stages of one call in the layer ``layer``: ``stage(name)``
    opens the profiler range ``sqz.<layer>.<name>`` while a profile is
    being recorded (``torch.profiler``), so that the trace puts the card's
    idle gaps under the stage that held it back, and adds the stage's host
    wall seconds to ``stats["<name>_s"]`` when a ``stats`` dict was given
    (accumulated). With neither, a stage costs one flag read.

    A timed stage waits for the current stream of ``sync`` (a CUDA device;
    None: it does not wait) before it reads the clock, so the device work
    it queued counts in it; a mesh's shards on other streams of the device
    run on. The profiler ranges never wait."""

    def __init__(self, layer: str, stats: dict = None, sync=None):
        self.layer = layer
        self.stats = stats
        self.sync = sync if sync is not None and \
            torch.device(sync).type == "cuda" else None

    def stage(self, name: str):
        """A context manager around the stage ``name``."""
        if self.stats is None and not _profiler._is_profiler_enabled:
            return _NO_STAGE
        return _Stage(self, name)


class _Stage:
    __slots__ = ("owner", "name", "span", "t0")

    def __init__(self, owner: Stages, name: str):
        self.owner = owner
        self.name = name
        self.span = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.span = torch.profiler.record_function(
                f"sqz.{self.owner.layer}.{self.name}")
            self.span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        st = self.owner
        if st.stats is not None and exc[0] is None:
            if st.sync is not None:
                torch.cuda.current_stream(st.sync).synchronize()
            key = f"{self.name}_s"
            st.stats[key] = st.stats.get(key, 0.0) + time.perf_counter() \
                - self.t0
        if self.span is not None:
            self.span.__exit__(*exc)
        return False


_NO_STAGE = contextlib.nullcontext()

# the sqzt container's stages around the codec (``api.compress`` /
# ``decompress``, the joins of blocks in ``engine``; profiler ranges only)
CONTAINER = Stages("container")
