"""sqz_tpu_torch: the sqz codecs on PyTorch, with CUDA kernels for Hopper.

A port of ``sqz_tpu`` (the JAX/TPU package, kept as the reference): the
same ``sqzt`` containers and payload bytes, with the sqz4 device engine
(``engine="torch"``) running hand-written CUDA kernels on an NVIDIA card,
or their plain PyTorch versions on the CPU. It imports neither JAX nor
any module of ``sqz_tpu``: the native host runtime (planners, packers,
host codec, assembler), the container framing and the input generators
are the port's own copies (``native``, ``formats``, ``utils``).
"""

from sqz_tpu_torch.api import (  # noqa: F401
    Engine,
    Format,
    compress,
    compress_resident,
    decompress,
    decompress_resident,
)

__version__ = "0.1.0"
