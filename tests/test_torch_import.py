"""The PyTorch port loads without JAX, and chip_smoke.py refuses to run
without a CUDA card.

Both run in subprocesses: the pytest process has imported jax already
(tests/conftest.py)."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "sqz_tpu_torch"


def _run(args, cwd, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import sqz_tpu_torch\n"
        "from sqz_tpu_torch import convert\n"
        "from sqz_tpu_torch.ops import _build, engine, sqz4_cuda, "
        "sqz4_host, sqz4_ref\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'jax' or m.startswith(('jax.', 'sqz_tpu.ops'))]\n"
        "assert not bad, bad\n")
    res = _run(["-c", code], ROOT)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")))
def test_port_sources_import_no_jax(path):
    src = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M)
    assert "sqz_tpu.ops" not in src


def test_chip_smoke_fails_without_a_card():
    # this host has no CUDA device: the script must exit non-zero and
    # print no result line
    res = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env_path = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env_path, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
