"""Element-wise primitive probes: the port of ``tools/pallas_probe.py``.

The reference's probes check, one small Pallas kernel each, that the TPU
compiles and computes the integer and float primitives its coder kernels
are built from. Here each probe is a body of one CUDA kernel
(``csrc/probe.cu``, picked by index) on the reference's inputs, beside
its plain PyTorch version (for CPU tensors) and its expected value
(numpy; the reference's own check where it has one).

    from sqz_tpu_torch.ops import probe
    results = probe.run_probes("cuda")    # {name: (got, want)} numpy u32
    assert all((g == w).all() for g, w in results.values())

``probe.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from sqz_tpu_torch import convert
from sqz_tpu_torch.ops import launch
from sqz_tpu_torch.ops.sqz4_ref import I64, M32, to_u32

B = 128                # lanes, as the reference's (1, 128) probe rows
ROWS = 256             # rows of the sublane probes' table
PROBES = ("var_shl", "var_shr", "clz_u32", "mul_lo", "mulhi_emul",
          "sublane_reduce", "sublane_cumsum", "while_loop", "onehot_extract",
          "f32_div", "u8_convert", "dyn_sublane_read", "smem_scalar",
          "u64_native")


def inputs():
    """The reference's probe inputs (tools/pallas_probe.py:31-124), by
    name."""
    x = np.arange(B, dtype=np.uint32).reshape(1, B) * np.uint32(0x01010101)
    s = (np.arange(B, dtype=np.uint32) % 31).reshape(1, B)
    return dict(
        x=x, s=s, s3=s + np.uint32(3),
        y=(x * np.uint32(2654435761)).astype(np.uint32),
        t=np.arange(ROWS * B, dtype=np.uint32).reshape(ROWS, B) % 97,
        idx=(np.arange(B, dtype=np.uint32) % 256).reshape(1, B),
        num=(np.arange(B, dtype=np.uint32) * 12347 % (1 << 22)).reshape(1, B),
        den=(np.arange(B, dtype=np.uint32) % 1000 + 1).reshape(1, B),
        u8buf=(np.arange(64 * B) % 251).astype(np.uint8).reshape(64, B),
        off=np.array([[3]], dtype=np.int32),
        scalar=np.array([7], dtype=np.uint32))


# each probe's two kernel inputs (names in ``inputs()``; None: unused)
ARGS = {
    "var_shl": ("x", "s"), "var_shr": ("x", "s"), "clz_u32": ("x", None),
    "mul_lo": ("x", "s3"), "mulhi_emul": ("x", "y"),
    "sublane_reduce": ("t", None), "sublane_cumsum": ("t", None),
    "while_loop": ("x", None), "onehot_extract": ("t", "idx"),
    "f32_div": ("num", "den"), "u8_convert": ("u8buf", None),
    "dyn_sublane_read": ("t", "off"), "smem_scalar": ("scalar", "t"),
    "u64_native": ("x", None),
}


def expected(name: str) -> np.ndarray:
    """The probe's value by numpy: what the reference's Pallas body
    computes (its own check for mulhi_emul and f32_div). u64_native is
    the exception: its value is what the probe asks for, the native 64-bit
    high word of x * x. tools/pallas_probe.py runs without
    ``jax_enable_x64``, so its body's ``astype(uint64)`` stays u32 and the
    reference's output is 0."""
    d = inputs()
    x, s, t = d["x"], d["s"], d["t"]
    u64 = np.uint64
    want = {
        "var_shl": lambda: x << s,
        "var_shr": lambda: x >> s,
        "clz_u32": lambda: np.array([[32 - int(v).bit_length()
                                      for v in x[0]]], np.uint32),
        "mul_lo": lambda: x * d["s3"],
        "mulhi_emul": lambda: ((x.astype(u64) * d["y"].astype(u64))
                               >> u64(32)).astype(np.uint32),
        "sublane_reduce": lambda: t.sum(0, keepdims=True, dtype=np.uint32),
        "sublane_cumsum": lambda: np.cumsum(t, 0, dtype=np.uint32),
        "while_loop": lambda: x * np.uint32(1 << 10),
        "onehot_extract": lambda: t[d["idx"][0], np.arange(B)][None],
        "f32_div": lambda: d["num"] // d["den"],
        "u8_convert": lambda: d["u8buf"][:1].astype(np.uint32),
        "dyn_sublane_read": lambda: t[int(d["off"][0, 0])][None],
        "smem_scalar": lambda: t[:1] + d["scalar"][0],
        "u64_native": lambda: ((x.astype(u64) * x.astype(u64))
                               >> u64(32)).astype(np.uint32),
    }[name]
    return np.asarray(want(), dtype=np.uint32)


def _u(t: torch.Tensor) -> torch.Tensor:
    """A probe input tensor as int64 holding its unsigned values."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(I64) & M32
    return t.to(I64)


def plain(name: str, a: torch.Tensor, b=None) -> torch.Tensor:
    """The probe in plain PyTorch, on any device: uint32 [1, B] (the
    cumsum [ROWS, B])."""
    a = _u(a)
    b = _u(b) if b is not None else None
    if name == "var_shl":
        r = a << b
    elif name == "var_shr":
        r = a >> b
    elif name == "clz_u32":
        thr = torch.tensor([1 << k for k in range(32)], dtype=I64,
                           device=a.device)
        r = 32 - (a[..., None] >= thr).sum(-1)
    elif name == "mul_lo":
        r = a * b
    elif name == "mulhi_emul":    # the reference's 16-bit split
        a0, a1, b0, b1 = a & 0xFFFF, a >> 16, b & 0xFFFF, b >> 16
        m00, m01, m10, m11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
        mid = (m00 >> 16) + (m01 & 0xFFFF) + (m10 & 0xFFFF)
        r = m11 + (m01 >> 16) + (m10 >> 16) + (mid >> 16)
    elif name == "sublane_reduce":
        r = a.sum(0, keepdim=True)
    elif name == "sublane_cumsum":
        r = a.cumsum(0)
    elif name == "while_loop":
        r = a
        for _ in range(10):
            r = (r + r) & M32
    elif name == "onehot_extract":
        r = torch.gather(a, 0, b)
    elif name == "f32_div":
        q = (a.to(torch.float32) * (1.0 / b.to(torch.float32))).to(I64)
        q = torch.where(((a - q * b) & M32) >= 1 << 31, q - 1, q)
        r = torch.where(((a - q * b) & M32) >= b, q + 1, q)
    elif name == "u8_convert":
        r = a[:1]
    elif name == "dyn_sublane_read":
        r = a[int(b[0, 0])][None]
    elif name == "smem_scalar":
        r = b[:1] + a[0]
    elif name == "u64_native":
        # int64 products wrap as u64 ones do; to_u32 keeps bits 32..63
        r = (a * a) >> 32
    else:
        raise ValueError(f"unknown probe {name!r}")
    return to_u32(r)


def probe(name: str, a: torch.Tensor, b=None) -> torch.Tensor:
    """Run one probe: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    dev = a.device
    if b is not None and b.device != dev:
        raise ValueError("probe inputs lie on different devices")
    if dev.type == "cpu":
        return plain(name, a, b)
    if dev.type != "cuda":
        raise ValueError(f"no probe kernel for device {dev}")
    from sqz_tpu_torch.ops import _build
    rows = a.shape[0]
    shape = (rows, B) if name == "sublane_cumsum" else (1, B)
    out = torch.zeros(shape, dtype=torch.int32, device=dev).view(
        torch.uint32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.library().probe_launch(
            PROBES.index(name), a.contiguous().data_ptr(),
            b.contiguous().data_ptr() if b is not None else None,
            out.data_ptr(), B, rows, stream)
    launch.launched(rc, f"probe {name}")
    probe.launches += 1
    return out


probe.launches = 0


def probe_tensors(name: str, device):
    """The probe's inputs as tensors on ``device``."""
    d = inputs()
    return [convert.to_device(d[k], device) if k else None
            for k in ARGS[name]]


def run_probes(device="cuda"):
    """Every probe on ``device`` -> {name: (got, want)}, numpy u32."""
    return {name: (convert.to_numpy(probe(name, *probe_tensors(name,
                                                               device))),
                   expected(name)) for name in PROBES}
