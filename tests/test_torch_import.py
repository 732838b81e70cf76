"""The PyTorch port loads without JAX and without the JAX package (it
keeps its own copies of what it needs), and chip_smoke.py refuses to run
without a CUDA card.

The runtime checks run in subprocesses: the pytest process has imported
jax and sqz_tpu already (tests/conftest.py, the other tests)."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from sqz_tpu_torch import native

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "sqz_tpu_torch"


def _run(args, cwd, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def _imported_modules(path: Path):
    """Every module an import statement of the file names."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _foreign(name: str) -> bool:
    return name.split(".")[0] in ("jax", "sqz_tpu")


def test_import_leaves_jax_out():
    """Importing the port (its parallel package and check tools too) and
    small compress / decompress round trips on the CPU (cold, warm and
    anchored, the host engines, ranges and the resident paths, also over
    a mesh of two CPU shards) load neither jax nor any module of the JAX
    package."""
    native.build()    # the round trip needs the runtime: build it here
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import sqz_tpu_torch\n"
        "from sqz_tpu_torch import convert, native\n"
        "from sqz_tpu_torch.ops import _build, engine, pipeline, sqz4_cuda, "
        "sqz4_host, sqz4_ref\n"
        "from sqz_tpu_torch.formats import anchors, container\n"
        "from sqz_tpu_torch.utils import corpus\n"
        "data = corpus.texty(1500, seed=1)\n"
        "blob = sqz_tpu_torch.compress(data, blk_bits=10, win_bits=10, "
        "device='cpu')\n"
        "assert sqz_tpu_torch.decompress(blob, device='cpu') == data\n"
        "for warm in (True, 'anchors'):\n"
        "    blob = sqz_tpu_torch.compress(data, blk_bits=9, win_bits=10, "
        "warm=warm, device='cpu')\n"
        "    assert sqz_tpu_torch.decompress(blob, device='cpu') == data\n"
        "from sqz_tpu_torch.utils import checkpoint, stats\n"
        "from sqz_tpu_torch import oracle\n"
        "for engine in ('native', 'oracle'):\n"
        "    blob = sqz_tpu_torch.compress(data, blk_bits=10, win_bits=10, "
        "engine=engine)\n"
        "    assert sqz_tpu_torch.decompress(blob, engine=engine) == data\n"
        "    assert sqz_tpu_torch.decompress_range(blob, 5, 9, "
        "engine=engine) == data[5:14]\n"
        "for mode in ('lit', 'rle', 'lz'):\n"
        "    blob = sqz_tpu_torch.compress_resident(data, blk_bits=8, "
        "mode=mode, lanes=8, device='cpu')\n"
        "    out = sqz_tpu_torch.decompress_resident(blob, lanes=8, "
        "device='cpu')\n"
        "    assert out.numpy().tobytes() == data\n"
        "from sqz_tpu_torch.parallel import dryrun, mesh, multihost, shard\n"
        "from sqz_tpu_torch.tools import (check_dec, check_enc, check_lz,\n"
        "                                 check_resident)\n"
        "m = mesh.make_mesh(2, devices=[torch.device('cpu')] * 2)\n"
        "blob = sqz_tpu_torch.compress_resident(data, blk_bits=8, "
        "mode='rle', mesh=m)\n"
        "out = sqz_tpu_torch.decompress_resident(blob, mesh=m)\n"
        "assert out.numpy().tobytes() == data\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'sqz_tpu')]\n"
        "assert not bad, bad\n")
    res = _run(["-c", code], ROOT)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"])
def test_port_sources_import_no_jax(path):
    """No import statement of the port or of chip_smoke.py names jax or
    the JAX package (docstrings may name the reference)."""
    bad = [m for m in _imported_modules(ROOT / path) if _foreign(m)]
    assert not bad, bad


def test_cli_help_leaves_jax_out():
    """``python -m sqz_tpu_torch --help`` (the CLI, with the modules each
    subcommand loads) loads neither jax nor any module of the JAX
    package."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['sqz_tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('sqz_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "from sqz_tpu_torch.utils import checkpoint, stats\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'sqz_tpu')]\n"
        "assert not bad, bad\n")
    res = _run(["-c", code], ROOT)
    assert res.returncode == 0, res.stderr
    assert "ckpt-save" in res.stdout and "range" in res.stdout
    res = _run(["-m", "sqz_tpu_torch", "--help"], ROOT)
    assert res.returncode == 0 and "roundtrip" in res.stdout


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
