"""The resident encodes' launches of several lane groups: the lit and rle
modes hand the token kernel ``resident.LAUNCH_GROUPS`` groups a launch
(its group axis; the gangs of csrc/sqz4_encode_tok.cu then hold several
chains a scheduler), lz one. The containers equal those of one launch a
group and the JAX package's (its Pallas kernels in interpret mode), from
the same numpy-seeded input; the plain versions run on the CPU.
Tolerance is zero: a lossless codec."""

import numpy as np
import pytest
import torch

import sqz_tpu
import sqz_tpu_torch
from sqz_tpu_torch.ops import resident, sqz4_cuda
from sqz_tpu_torch.utils import synthetic

torch.set_num_threads(1)

LANES = 4        # blocks a lane group here: 14 blocks make four groups
REF_LANES = 32   # the reference's interpret-mode encoder lanes


@pytest.mark.parametrize("mode", ["lit", "rle", "lz"])
def test_launches_of_several_groups_equal_one_a_group(mode, monkeypatch):
    # the resident mix's five lane kinds, the last block a third long:
    # lit and rle launch three groups and then one, lz one at a time; the
    # payloads and their order are those of one launch a group
    data = synthetic.resident_mix(14, 9, seed=3)
    groups = []
    kernel = sqz4_cuda.encode_tok

    def spy(toks, *args, **kw):
        groups.append(int(toks.shape[0]))
        return kernel(toks, *args, **kw)

    monkeypatch.setattr(sqz4_cuda, "encode_tok", spy)
    kw = dict(blk_bits=9, mode=mode, lanes=LANES, device="cpu")
    multi = sqz_tpu_torch.compress_resident(data, **kw)
    assert groups == ([1, 1, 1, 1] if mode == "lz"
                      else [resident.LAUNCH_GROUPS, 1])
    monkeypatch.setattr(resident, "LAUNCH_GROUPS", 1)
    groups.clear()
    one = sqz_tpu_torch.compress_resident(data, **kw)
    assert groups == [1, 1, 1, 1]
    assert multi == one
    want = sqz_tpu.compress_resident(data, blk_bits=9, mode=mode,
                                     interpret=True, lanes=REF_LANES)
    assert multi == want
    assert sqz_tpu_torch.decompress(multi, engine="native") == data


def test_group_axis_views_rows_in_order():
    # in_groups: [G * B, ...] rows (or the parse's [1, G * B, ...]) as the
    # kernel's [G, B, ...] group axis, a view in row order
    rows = torch.arange(6 * 5).reshape(6, 5)
    g = resident.in_groups(rows, 3)
    assert g.shape == (3, 2, 5) and g.data_ptr() == rows.data_ptr()
    assert torch.equal(g.reshape(6, 5), rows)
    assert torch.equal(resident.in_groups(rows[None], 2).reshape(6, 5), rows)
    np.testing.assert_array_equal(g[1].numpy(), rows[2:4].numpy())
