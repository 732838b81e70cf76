"""The port's primitive probes (plain PyTorch versions, CPU) against the
values tools/pallas_probe.py expects, on its inputs.

The reference's probe kernels compile only for a TPU (no interpret run),
so the inputs are taken from that script's source, and the expected
values are what its Pallas bodies compute, by numpy (its own checks for
mulhi_emul and f32_div). u64_native expects the probe's intent, the
native 64-bit high word: the script runs with 64-bit types off, where its
body stays u32 and gives 0. Tolerance is zero."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from sqz_tpu_torch import convert
from sqz_tpu_torch.ops import probe

ROOT = Path(__file__).resolve().parents[1]
INPUT_NAMES = {"B", "x", "s", "t", "y", "idx", "num", "den", "u8buf", "off"}


def _reference_inputs():
    """The input assignments of tools/pallas_probe.py, evaluated alone
    (the script runs its TPU probes when imported)."""
    tree = ast.parse((ROOT / "tools" / "pallas_probe.py").read_text())
    ns = {"np": np}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in INPUT_NAMES):
            exec(compile(ast.Module([node], []), "pallas_probe", "exec"), ns)
    return ns


def test_inputs_are_the_references():
    ref = _reference_inputs()
    got = probe.inputs()
    assert ref["B"] == probe.B
    for name in INPUT_NAMES - {"B"}:
        np.testing.assert_array_equal(got[name], ref[name])
        assert got[name].dtype == ref[name].dtype
    np.testing.assert_array_equal(got["s3"], ref["s"] + 3)


def test_reference_checks_hold_for_the_expected_values():
    d = probe.inputs()
    want = ((d["x"].astype(np.uint64) * d["y"].astype(np.uint64))
            >> np.uint64(32)).astype(np.uint32)
    np.testing.assert_array_equal(probe.expected("mulhi_emul"), want)
    np.testing.assert_array_equal(probe.expected("f32_div"),
                                  d["num"] // d["den"])


@pytest.mark.parametrize("name", probe.PROBES)
def test_plain_probe_equals_expected(name):
    got = probe.probe(name, *probe.probe_tensors(name, "cpu"))
    np.testing.assert_array_equal(convert.to_numpy(got),
                                  probe.expected(name))


def test_run_probes_on_the_cpu_launches_nothing():
    before = probe.probe.launches
    res = probe.run_probes("cpu")
    assert sorted(res) == sorted(probe.PROBES)
    for got, want in res.values():
        np.testing.assert_array_equal(got, want)
    assert probe.probe.launches == before


def test_probe_refuses_other_devices():
    a = torch.zeros((1, probe.B), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        probe.probe("var_shl", a.view(torch.uint32))
    with pytest.raises(ValueError):
        probe.plain("no_such_probe", torch.zeros((1, probe.B),
                                                 dtype=torch.int64))
