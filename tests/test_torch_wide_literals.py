"""sqz4 at ``blk_bits`` 18 on random bytes: one block of literals, whose
literal-flag model's total passes 2^17, where the 64 KiB kernels' divider
stopped. The plain PyTorch versions of the stats-fed encoder and the
decoder against the native engine and the JAX package's scan route (in a
file of its own: the plain decoder steps 140,000 times).

Tolerance is zero: payloads and restored bytes must be equal byte for
byte."""

import torch

from sqz_tpu.ops import sqz4_jax
from sqz_tpu.ops.engine import _tokenize
from sqz_tpu.utils import corpus
from sqz_tpu_torch import native
from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host

# the plain versions step over small tensors: one intra-op thread
torch.set_num_threads(1)

WIN = 15


def test_random_bytes_at_blk_bits_18_pass_the_old_divider_range():
    # one block of 140,000 random bytes: 140,000 literal flags, so the
    # flag model's total passes 2^17, where the 64 KiB kernels' divider
    # stopped. The plain stats-fed encoder gives the native payload and
    # the reference's scan route's; the plain decoder restores it.
    data = corpus.random_bytes(140_000, seed=4)
    start, size, total = host.op_stream_stats(data, 1 << WIN, 18)
    assert int(total.max()) > 1 << 17
    got = sqz4_cuda.encode_data_stats(data, 18, 1 << WIN, True,
                                      device="cpu")
    assert got == [native.sqz4_compress_payload(data, 1 << WIN)]
    toks = [_tokenize(data, 1 << WIN, 2, 254, True, True)]
    assert got == sqz4_jax.encode_blocks(toks, 18)
    assert sqz4_cuda.decode_groups(got, [len(data)], 18, device="cpu",
                                   lanes=host.group_lanes(1)) == [data]
