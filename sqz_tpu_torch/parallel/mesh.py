"""The port's device mesh (``sqz_tpu/parallel/mesh.py``): the ordered
local devices that blocks shard over, this process's rank and the world
size of its process group, and one CUDA stream a local shard.

A mesh may name one device more than once: ``make_mesh(4,
devices=[torch.device("cuda:0")] * 4)`` is four virtual shards of one
card, each on its own stream (the counterpart of the reference's virtual
8-device CPU mesh), and ``[torch.device("cpu")] * n`` gives n shards of
the plain versions on the CPU. Across processes (``multihost.bootstrap``)
every process builds a mesh of the same number of local shards; shard i
of rank r is global shard ``r * local_size + i``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


class Mesh:
    """A 1-D mesh over the block axis (see the module)."""

    def __init__(self, devices: Sequence, axis: str = "blocks"):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1 or devs[0].type not in (
                "cuda", "cpu"):
            raise ValueError(f"a mesh takes CUDA devices or CPU devices, "
                             f"not {devs}")
        if devs[0].type == "cuda":
            devs = [torch.device("cuda", torch.cuda.current_device()
                                 if d.index is None else d.index)
                    for d in devs]
            self.streams = tuple(torch.cuda.Stream(device=d) for d in devs)
        else:
            self.streams = (None,) * len(devs)
        self.devices = tuple(devs)
        self.axis = axis
        if dist.is_available() and dist.is_initialized():
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, self.world = 0, 1

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards over every process."""
        return self.local_size * self.world

    def global_shard(self, i: int) -> int:
        return self.rank * self.local_size + i

    def __repr__(self):
        return (f"Mesh({self.axis!r}: {[str(d) for d in self.devices]}, "
                f"rank {self.rank} of {self.world})")


def make_mesh(n_devices: Optional[int] = None, axis: str = "blocks",
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over ``devices`` (default: every local CUDA card), cut
    to the first ``n_devices``. Without a card, pass the devices
    (``[torch.device("cpu")] * n`` for the plain versions)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the mesh: pass devices= "
                               "(e.g. [torch.device('cpu')] * n)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"{n_devices} shards asked of {len(devs)} "
                             f"devices")
        devs = devs[:n_devices]
    return Mesh(devs, axis)


def check_mesh(mesh) -> Mesh:
    """``mesh`` itself, if it is a ``Mesh``; TypeError otherwise."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a sqz_tpu_torch.parallel.mesh.Mesh "
                        f"(make_mesh), not {type(mesh).__name__}")
    return mesh
