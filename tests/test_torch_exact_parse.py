"""The exact parse as the card computes it (``sqz4_ref.exact_parse_ref``:
the whole window a candidate at every find, the max of the (length,
j - lo) key, the greedy walk, the op emission of
``csrc/sqz4_exact_parse.cu``) against the native planner
(``native.sqz4_plan_pack``) byte for byte, at a 2^10-byte window and
blocks of 2^10 to 2^12 bytes; the CPU path of ``sqz4_cuda.exact_parse``
(the native planner through ``sqz4_host.exact_op_streams``) gives the
same words and counts, and ``sqz4_host.seed_from_ops`` of block 0's ops
the planner's warm seed. Tolerance is zero."""

import numpy as np
import pytest
import torch

from sqz_tpu_torch import native
from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host, sqz4_ref
from sqz_tpu_torch.utils import corpus

# the plain version steps a find at a time over small tensors
torch.set_num_threads(1)

WIN = 1 << 10

# (data, blk_bits, lz, warm)
CASES = {
    "texty": (corpus.texty(3 * 1024 + 700, seed=5), 10, True, False),
    "random": (corpus.random_bytes(2 * 1024 + 100, seed=6), 10, True,
               False),
    # every find hits the cap at distance 1
    "zeros": (corpus.zeros(2 * 4096), 12, True, False),
    # a run that ends at the block's end: the cap falls below 254
    "run_at_end": (corpus.texty(1500, seed=7) + corpus.zeros(548)
                   + corpus.texty(900, seed=8), 11, True, False),
    "short_last": (corpus.texty(2 * 2048 + 37, seed=9), 11, True, False),
    "empty": (b"", 10, True, False),
    "no_lz": (corpus.texty(2500, seed=10), 10, False, False),
    # blocks 1+ match into block 0's tail; block 0's ops give the seed
    "warm": (corpus.texty(2048 + 600, seed=11) + corpus.rle4(700)
             + corpus.texty(1800, seed=12), 11, True, True),
}


def _lanes(data: bytes, bits: int):
    bs = 1 << bits
    offs = [b * bs for b in range(max(1, -(-len(data) // bs)))]
    return offs, [min(bs, len(data) - o) for o in offs]


def _u32(t):
    return t.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_parse_ref_equals_native_planner(case):
    data, bits, lz, warm = CASES[case]
    offs, lens = _lanes(data, bits)
    rows = host.op_stream_cap(bits, len(data)) // 4
    flat = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    m, s, counts = sqz4_ref.exact_parse_ref(flat, offs, lens, WIN, lz, rows,
                                            warm)
    plan = native.sqz4_plan_pack(data, WIN, bits, lz, 1, 4 * rows,
                                 warm=warm)
    np.testing.assert_array_equal(_u32(m), plan[0][:, :, 0])
    np.testing.assert_array_equal(_u32(s), plan[1][:, :, 0])
    want = (plan[0][:, :, 0].astype(">u4").view(np.uint8) != 0xFF).sum(1)
    assert counts.tolist() == want.tolist()
    assert int(counts.max()) == plan[2]
    gm, gs, gc = sqz4_cuda.exact_parse(flat, offs, lens, WIN, lz, rows,
                                       warm)
    np.testing.assert_array_equal(_u32(gm), _u32(m))
    np.testing.assert_array_equal(_u32(gs), _u32(s))
    assert gc.tolist() == counts.tolist()
    if warm:
        seed = host.seed_from_ops(_u32(m[0]), _u32(s[0]), int(counts[0]))
        np.testing.assert_array_equal(seed, plan[3])
