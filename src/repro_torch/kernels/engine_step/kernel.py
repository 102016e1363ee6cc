"""The CUDA ``engine_step`` kernel: build, bind and launch.

The source is ``repro_torch/csrc/engine_step.cu``.  It is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
the first time a launch needs it, cached by the source's content hash
(under ``build/repro_torch/`` of the checkout when the package runs from
its source tree, else under the user's cache directory), and bound with
``ctypes``.  Nothing here runs at import time, so CPU-only hosts import
this module freely; a launch on a host without ``nvcc`` raises.

``fused_step_cuda`` launches the kernel on PyTorch's current stream and
adds one to ``LAUNCHES["engine_step"]`` per launch.  It updates the
bank-state tensors in place and returns them in the result dict.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

from repro_torch.core.metrics import LAT_BINS
from repro_torch.core.protocols.base import (KERNEL_AMO, KERNEL_LRSC,
                                             KERNEL_QUEUE)
from repro_torch.kernels import LAUNCHES

#: the package root (``.../repro_torch``) and the kernel source in it
_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "engine_step.cu"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    """Where the library is built: ``build/repro_torch/`` of the checkout
    when the package runs from its source tree (``<root>/src/repro_torch``
    beside ``<root>/pyproject.toml``), else ``repro_torch/`` under the
    user's cache directory (``$XDG_CACHE_HOME`` or ``~/.cache``)."""
    root = _PKG.parent.parent
    if _PKG.parent.name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # PyTorch's own toolkit lookup (CUDA_HOME / CUDA_PATH / the default
    # install prefix)
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "it is needed to build the engine_step CUDA kernel")


def build() -> Dict[str, str]:
    """Compile the kernel library if this source has not been built yet.
    Returns ``{"path": ..., "log": ...}`` (the log holds ``ptxas -v``'s
    register/shared-memory report when a build ran, else is empty)."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = build_dir() / f"libengine_step_{digest}.so"
    if out.exists():
        return {"path": str(out), "log": ""}
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the engine_step kernel failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return {"path": str(out), "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=1)
def _launcher():
    lib = ctypes.CDLL(build()["path"])
    fn = lib.engine_step_launch
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


#: bank-state arrays each protocol family carries, with their dtypes
_BANK_LAYOUT = {
    KERNEL_AMO: {},
    KERNEL_LRSC: {"resv_core": torch.int32, "resv_valid": torch.bool},
    KERNEL_QUEUE: {"qbuf": torch.int32, "qhead": torch.int32,
                   "qlen": torch.int32, "wake_tmr": torch.int32},
}


def fused_step_cuda(proto, p, bank: Dict, *, cand_cyc, rot, addr, phase,
                    acq_start, core: Dict, cyc: int, shift: int, lat: int,
                    n: int, a: int, q_cap: int, cycles: int) -> Dict:
    """Launch the CUDA kernel; same contract as ``ref.fused_step_ref``,
    except that the bank tensors are updated in place."""
    code = proto.kernel_code
    if code not in _BANK_LAYOUT:
        raise NotImplementedError(
            f"the engine_step CUDA kernel has no branch for protocol "
            f"{proto.name!r}")
    if proto.fused_core_fields or proto.fused_xset_fields or core:
        raise NotImplementedError(
            f"protocol {proto.name!r} needs per-core fields, which the "
            f"engine_step CUDA kernel does not take yet")
    dev = cand_cyc.device
    if dev.type != "cuda":
        raise ValueError(f"fused_step_cuda needs CUDA tensors, got {dev}")
    for name, t in (("cand_cyc", cand_cyc), ("rot", rot), ("addr", addr),
                    ("phase", phase), ("acq_start", acq_start)):
        _check(name, t, (n,), torch.int32, dev)
    layout = _BANK_LAYOUT[code]
    if set(bank) != set(layout):
        raise ValueError(f"bank state keys {sorted(bank)} do not match "
                         f"protocol {proto.name!r} ({sorted(layout)})")
    for k, dt in layout.items():
        shape = (a, q_cap) if k == "qbuf" else (a,)
        _check(k, bank[k], shape, dt, dev)

    valid = torch.empty((a,), dtype=torch.bool, device=dev)
    win, kind, tmr = (torch.empty((a,), dtype=torch.int32, device=dev)
                      for _ in range(3))
    acc = torch.zeros((3 + LAT_BINS,), dtype=torch.int32, device=dev)
    stats, hist = acc[:3], acc[3:]
    wake_delay, succ = proto.kernel_args(p)

    def ptr(k):
        return bank[k].data_ptr() if k in bank else None

    err = _launcher()(
        cand_cyc.data_ptr(), rot.data_ptr(), addr.data_ptr(),
        phase.data_ptr(), acq_start.data_ptr(),
        ptr("resv_core"), ptr("resv_valid"), ptr("qbuf"), ptr("qhead"),
        ptr("qlen"), ptr("wake_tmr"),
        valid.data_ptr(), win.data_ptr(), kind.data_ptr(), tmr.data_ptr(),
        stats.data_ptr(), hist.data_ptr(),
        n, a, code, q_cap, cyc, shift, lat, wake_delay, succ, cycles,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"engine_step kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["engine_step"] += 1
    return dict(valid=valid, win=win, kind=kind, tmr=tmr, bank=bank,
                xset={}, polls=stats[0], msgs=stats[1], hist=hist,
                lat_max=stats[2])
