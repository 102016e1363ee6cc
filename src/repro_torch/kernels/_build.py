"""Build and bind the port's CUDA kernels.

Each kernel's source is ``repro_torch/csrc/<name>.cu`` with a plain C
interface.  It is compiled with ``nvcc`` for ``sm_90a`` into a shared
library the first time a launch needs it, cached by the source's
content hash (under ``build/repro_torch/`` of the checkout when the
package runs from its source tree, else under the user's cache
directory), and bound with ``ctypes``.  Nothing here runs at import
time, so CPU-only hosts import the kernel modules freely; a launch on a
host without ``nvcc`` raises.
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

#: the package root (``.../repro_torch``); sources live in its ``csrc/``
PKG = Path(__file__).resolve().parents[1]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def source(name: str) -> Path:
    """The CUDA source of kernel ``name``."""
    return PKG / "csrc" / f"{name}.cu"


def build_dir(pkg: Path = PKG) -> Path:
    """Where the libraries are built: ``build/repro_torch/`` of the
    checkout when the package runs from its source tree
    (``<root>/src/repro_torch`` beside ``<root>/pyproject.toml``), else
    ``repro_torch/`` under the user's cache directory
    (``$XDG_CACHE_HOME`` or ``~/.cache``)."""
    root = pkg.parent.parent
    if pkg.parent.name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch"


def _nvcc(name: str) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # PyTorch's own toolkit lookup (CUDA_HOME / CUDA_PATH / the default
    # install prefix)
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       f"it is needed to build the {name} CUDA kernel")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes()).hexdigest()[:16]
    return build_dir() / f"lib{name}_{digest}.so"


def built(name: str) -> bool:
    """Whether kernel ``name``'s library for this source is on disk
    already (a load that needs no ``nvcc``)."""
    return _library_path(name).exists()


def build(name: str) -> Dict[str, str]:
    """Compile kernel ``name``'s library if this source has not been
    built yet.  Returns ``{"path": ..., "log": ...}`` (the log holds
    ``ptxas -v``'s register/shared-memory report when a build ran, else
    is empty)."""
    src = source(name)
    out = _library_path(name)
    if out.exists():
        return {"path": str(out), "log": ""}
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(name), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the {name} kernel failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return {"path": str(out), "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """Kernel ``name``'s library, built if needed and loaded once."""
    return ctypes.CDLL(build(name)["path"])
