"""The CUDA ``rglru_scan`` kernel: bind and launch.

The source is ``repro_torch/csrc/rglru_scan.cu``, built and loaded by
``repro_torch.kernels._build`` (``nvcc`` at first use, cached by content
hash; nothing runs at import time).

``rglru_scan_cuda`` launches the kernel on PyTorch's current stream and
adds one to ``LAUNCHES["rglru_scan"]`` per launch; ``rglru_scan_bwd_cuda``
is the gradient, one launch of the same kernel on time-reversed copies
(the adjoint ``g_t = dy_t + a_{t+1} g_{t+1}`` is the recurrence run
backwards with ``a`` one step ahead), counted under
``LAUNCHES["rglru_scan_bwd"]``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build


@functools.lru_cache(maxsize=1)
def _launcher():
    lib = _build.library("rglru_scan")
    for name in ("rglru_scan_scratch_ints", "rglru_scan_scratch_floats"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_longlong] * 3
        fn.restype = ctypes.c_longlong
    fn = lib.rglru_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 11 \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def unit_along_w(x: torch.Tensor) -> bool:
    """Whether ``x``'s last axis (w) has unit stride, as the kernel needs."""
    return x.shape[-1] == 1 or x.stride(-1) == 1


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor, counter: str = "rglru_scan",
                    ordered: bool = False) -> torch.Tensor:
    """a, b ``(T, B, w)`` and h0 ``(B, w)``, float32 with unit stride
    along w (any strides along T and B), on one CUDA device -> h ``(T, B,
    w)`` float32 with a's strides.  Raises on anything the kernel does
    not take.  The launch is counted under ``LAUNCHES[counter]``;
    ``ordered`` takes the look-back that gives the same bits every
    launch."""
    if not all(t.dtype == torch.float32 for t in (a, b, h0)):
        raise ValueError(f"a, b, h0 must be float32, got {a.dtype}, "
                         f"{b.dtype}, {h0.dtype}")
    if a.dim() != 3 or b.shape != a.shape or tuple(h0.shape) != a.shape[1:]:
        raise ValueError(f"need a, b (T, B, w) and h0 (B, w), got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")
    t, bdim, w = a.shape
    if min(t, bdim, w) < 1:
        raise ValueError(f"need T, B, w >= 1, got {t}, {bdim}, {w}")
    if not all(unit_along_w(x) for x in (a, b, h0)):
        raise ValueError(f"a, b and h0 need unit stride along w, got "
                         f"{a.stride()}, {b.stride()}, {h0.stride()}")
    dev = a.device
    if dev.type != "cuda" or b.device != dev or h0.device != dev:
        raise ValueError(f"rglru_scan_cuda needs CUDA tensors on one device, "
                         f"got {a.device}, {b.device}, {h0.device}")
    launch = _launcher()
    lib = _build.library("rglru_scan")
    out = torch.empty_like(a)
    if out.stride(-1) != 1:
        out = torch.empty((t, bdim, w), dtype=torch.float32, device=dev)
    ints = torch.zeros(lib.rglru_scan_scratch_ints(t, bdim, w),
                       dtype=torch.int32, device=dev)
    floats = torch.empty(lib.rglru_scan_scratch_floats(t, bdim, w),
                         dtype=torch.float32, device=dev)
    err = launch(a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(),
                 t, bdim, w, a.stride(0), a.stride(1), b.stride(0),
                 b.stride(1), out.stride(0), out.stride(1), h0.stride(0),
                 int(ordered), ints.data_ptr(), floats.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[counter] += 1
    return out


def rglru_scan_bwd_cuda(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                        dh: torch.Tensor):
    """The gradient of ``h = rglru_scan(a, b, h0)`` at ``dh``: ``(da, db,
    dh0)`` float32 in the shapes of a, b, h0, from the forward's a, h and
    h0 (all ``(T, B, w)`` but h0 ``(B, w)``, float32, on one CUDA
    device).  ``g = db`` solves ``g_t = dh_t + a_{t+1} g_{t+1}``
    (``g_{T-1} = dh_{T-1}``): ONE launch of the scan kernel over the
    reversed time axis, ``a`` shifted one step (``a_T = 0``) and h0 = 0,
    with the ordered look-back (the same bits every launch), counted
    under ``"rglru_scan_bwd"``; then ``da_t = g_t h_{t-1}`` (h_{-1} = h0)
    and ``dh0 = a_0 g_0``, elementwise."""
    t = a.shape[0]
    a_rev = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    a_rev[0].zero_()
    a_rev[1:] = a[1:].flip(0)
    g = rglru_scan_cuda(a_rev, dh.float().flip(0), torch.zeros_like(h0),
                        counter="rglru_scan_bwd", ordered=True).flip(0)
    h_prev = torch.cat([h0[None].float(), h[:t - 1]], dim=0)
    return g * h_prev, g, a[0] * g[0]
