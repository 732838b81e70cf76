"""Scalar pure-Python reference implementations (the differential oracle).

These are deliberately simple and readable; they define correct behavior for
the native C++ runtime and the device kernels, which are tested bit-for-bit
against them. They are NOT the fast path — use ``sqz_tpu_torch.native`` on
the host and ``sqz_tpu_torch.ops`` on the card.

The port's copy of ``sqz_tpu/oracle`` (the engine modules; the reference
hash-map parse ``refmap`` is not copied yet).
"""

from sqz_tpu_torch.oracle.squeeze import (  # noqa: F401
    squeeze_compress,
    squeeze_decompress,
)
from sqz_tpu_torch.oracle.sqz4 import (  # noqa: F401
    sqz4_compress,
    sqz4_decompress,
)
