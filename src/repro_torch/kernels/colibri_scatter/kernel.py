"""The CUDA ``colibri_scatter`` commit kernel: bind and launch.

The source is ``repro_torch/csrc/colibri_scatter.cu``, built and loaded
by ``repro_torch.kernels._build`` (``nvcc`` at first use, cached by
content hash; nothing runs at import time).

``scatter_commit_cuda`` launches the kernel on PyTorch's current stream
and adds one to ``LAUNCHES["colibri_scatter"]`` per launch.  The
kernel's scratch (an atomic ticket and a word per chunk and column) is
kept from launch to launch, one per (device, stream): the ticket resets
itself and the words carry the launch's epoch, so no launch needs a
zeroing launch before it.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build

#: vals/out dtypes the kernel takes, with its dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: epochs run 1 .. EPOCHS - 1; the scratch is zeroed when they start
#: again at 1 (the kernel packs the epoch into 31 bits)
EPOCHS = 1 << 30
#: the least scratch allocated, in 8-byte words: streams of up to ~1 M
#: rows at d = 1, the trace path's among them, never grow it
MIN_WORDS = 1 << 10

#: (device index, stream) -> [scratch, last epoch]; two launches must
#: never share an epoch, so _LOCK guards the count
_SCRATCH: Dict[Tuple[int, int], List] = {}
_LOCK = threading.Lock()


@functools.lru_cache(maxsize=1)
def _library():
    lib = _build.library("colibri_scatter")
    lib.colibri_commit_scratch_words.argtypes = [ctypes.c_longlong,
                                                 ctypes.c_int]
    lib.colibri_commit_scratch_words.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = _library().colibri_commit_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _scratch(dev: torch.device, stream: int, t: int,
             d: int) -> Tuple[torch.Tensor, int]:
    """This stream's scratch, grown (zeroed) if ``(t, d)`` needs more,
    and the epoch of the next launch."""
    need = _library().colibri_commit_scratch_words(t, d)
    key = (dev.index, stream)
    with _LOCK:
        entry = _SCRATCH.get(key)
        if entry is None or entry[0].numel() < need:
            old = 0 if entry is None else entry[0].numel()
            entry = [torch.zeros(max(need, 2 * old, MIN_WORDS),
                                 dtype=torch.int64, device=dev), 0]
            _SCRATCH[key] = entry
        entry[1] += 1
        if entry[1] == EPOCHS:
            entry[0].zero_()
            entry[1] = 1
        return entry[0], entry[1]


def scatter_commit_cuda(sorted_keys: torch.Tensor, sorted_vals: torch.Tensor,
                        num_bins: int) -> torch.Tensor:
    """Segmented commit of a key-sorted stream: keys ``(T,)`` int32
    sorted ascending, vals ``(T, d)`` float32 or bfloat16 ->
    ``(num_bins, d)`` in vals' dtype.  Keys outside ``[0, num_bins)``
    are dropped.  Raises on anything the kernel does not take."""
    keys, vals = sorted_keys, sorted_vals
    dev = keys.device
    if dev.type != "cuda" or vals.device != dev:
        raise ValueError(f"scatter_commit_cuda needs CUDA tensors on one "
                         f"device, got {keys.device} and {vals.device}")
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError(f"keys must be (T,) int32, got {keys.dtype}"
                         f"{tuple(keys.shape)}")
    if vals.dtype not in DTYPES or vals.dim() != 2:
        raise ValueError(f"vals must be (T, d) float32 or bfloat16, got "
                         f"{vals.dtype}{tuple(vals.shape)}")
    t, d = vals.shape
    if keys.shape[0] != t:
        raise ValueError(f"{keys.shape[0]} keys for {t} rows of vals")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("keys and vals must be contiguous")
    if num_bins < 1 or d < 1:
        raise ValueError(f"need num_bins >= 1 and d >= 1 (got {num_bins}, "
                         f"{d})")
    launch = _launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch, epoch = _scratch(dev, stream, t, d)
    out = torch.empty((num_bins, d), dtype=vals.dtype, device=dev)
    err = launch(keys.data_ptr(), vals.data_ptr(), out.data_ptr(), t, d,
                 num_bins, DTYPES[vals.dtype], scratch.data_ptr(),
                 scratch.numel(), epoch, stream)
    if err != 0:
        raise RuntimeError(f"colibri_scatter kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["colibri_scatter"] += 1
    return out
