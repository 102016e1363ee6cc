"""The CUDA ``flash_attention`` kernel: bind and launch.

The sources are ``repro_torch/csrc/flash_attention.cu`` (the forward)
and ``flash_attention_bwd.cu`` (its gradient), built and loaded by
``repro_torch.kernels._build`` (``nvcc`` at first use, cached by content
hash; nothing runs at import time).

``flash_attention_cuda`` launches the forward on PyTorch's current stream
(causal or not, with a window or not, v's head dim q's or MLA's 128 under
192) and adds one to ``LAUNCHES["flash_attention"]`` per launch;
``flash_attention_fwd_lse_cuda`` launches the same kernel with the row
log-sum-exp as a second output (also counted under ``"flash_attention"``),
and ``flash_attention_bwd_cuda`` the backward's two kernels, counted under
``"flash_attention_bwd_dq"`` and ``"flash_attention_bwd_dkdv"``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build

#: q/k/v/o dtypes the kernel takes, with its dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (q/k head dim, v head dim) pairs the forward is instantiated for: one
#: head dim at each of 32, 64, 80 (stablelm-3b), 96 (phi-3-vision), 112,
#: 128, 256, and MLA's 192 over 128
HEAD_DIMS = ((32, 32), (64, 64), (80, 80), (96, 96), (112, 112), (128, 128),
             (256, 256), (192, 128))
#: the pairs of the forward's lse entry (training): v's head dim is q's
LSE_HEAD_DIMS = tuple(p for p in HEAD_DIMS if p[0] == p[1])
#: head dims the backward kernels are instantiated for (v's is q's)
BWD_HEAD_DIMS = (32, 64, 80, 96, 112, 128, 256)


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = _build.library("flash_attention").flash_attention_window_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1)
def _lse_launcher():
    fn = _build.library("flash_attention").flash_attention_lse_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


#: the backward launches' C signature (``flash_attention_bwd_abi()`` in
#: the source says its version, ``BWD_ABI``): q, k, v, o or dout, dout or
#: lse, lse or delta, delta or dk, dq or dv; batch, sq, skv, heads,
#: kv_heads, hd, causal, window; scale, dtype, stream
BWD_ABI = 1
BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=1)
def _bwd_launchers():
    lib = _build.library("flash_attention_bwd")
    if lib.flash_attention_bwd_abi() != BWD_ABI:
        raise RuntimeError("flash_attention_bwd.cu's launches are not the "
                           f"signature this module binds (ABI {BWD_ABI})")
    dq, dkdv = lib.flash_attention_bwd_dq_launch, \
        lib.flash_attention_bwd_dkdv_launch
    for fn in (dq, dkdv):
        fn.argtypes, fn.restype = BWD_ARGS, ctypes.c_int
    return dq, dkdv


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           head_dims=HEAD_DIMS, what: str = "flash_attention_cuda"):
    """Raise unless q ``(B, Sq, H, hd)``, k ``(B, Skv, KV, hd)`` and v
    ``(B, Skv, KV, hdv)`` are what the kernels take, ``(hd, hdv)`` in
    ``head_dims``; return (b, sq, skv, h, kv, hd, hdv)."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"{what} needs CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"need q (B, Sq, H, hd), k (B, Skv, KV, hd) and v "
                         f"(B, Skv, KV, hdv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    skv, kv, hdv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != hd or h % kv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match (batch, head dim, H % KV == 0)")
    if (hd, hdv) not in head_dims:
        raise ValueError(f"head dim {hd} (v {hdv}): the (q/k, v) pairs "
                         f"are {head_dims}")
    if min(b, sq, skv) < 1 or b * kv > 65535:
        raise ValueError(f"need B, Sq, Skv >= 1 and B * KV <= 65535, got "
                         f"{b}, {sq}, {skv}, {b * kv}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries")
    return b, sq, skv, h, kv, hd, hdv


def _check_window(window, causal: bool, sq: int, skv: int) -> int:
    """``window`` as an int; raises unless it is 0, or > 0 with causal
    attention and ``Sq <= Skv``."""
    window = int(window)
    if window < 0 or (window and (not causal or sq > skv)):
        raise ValueError(f"window {window}: a window is >= 0, and one > 0 "
                         f"needs causal=True and Sq <= Skv (got causal="
                         f"{causal}, Sq {sq}, Skv {skv})")
    return window


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q ``(B, Sq, H, hd)``, k ``(B, Skv, KV, hd)`` and v ``(B, Skv, KV,
    hdv)``, contiguous and on 16-byte boundaries, all float32 or all
    bfloat16, ``H % KV == 0``, ``(hd, hdv)`` in ``HEAD_DIMS`` -> ``(B, Sq,
    H, hdv)`` in q's dtype, scaled by ``hd ** -0.5``.  Query head h reads
    KV head ``h // (H // KV)``.  A ``window`` > 0 (causal, ``Sq <= Skv``)
    also hides key j from query i when ``i - j >= window``.  Raises on
    anything the kernel does not take."""
    b, sq, skv, h, kv, hd, hdv = _check(q, k, v)
    window = _check_window(window, causal, sq, skv)
    out = torch.empty((b, sq, h, hdv), dtype=q.dtype, device=q.device)
    _raise_on(_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        h, kv, hd, hdv, int(causal), window, hd ** -0.5, DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_fwd_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, causal: bool = True,
                                 window: int = 0):
    """``flash_attention_cuda`` that also returns each query row's
    natural-log log-sum-exp of its scaled, masked scores: ``(o, lse)``,
    lse float32 ``(B, H, Sq)`` (what the backward recomputes P from).
    The same kernel: o has the bits ``flash_attention_cuda`` gives, with
    the same ``window``.  v's head dim is q's."""
    b, sq, skv, h, kv, hd, _ = _check(q, k, v, LSE_HEAD_DIMS,
                                      "flash_attention_fwd_lse_cuda")
    window = _check_window(window, causal, sq, skv)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _raise_on(_lse_launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), lse.data_ptr(), b, sq, skv, h,
                              kv, hd, int(causal), window, hd ** -0.5,
                              DTYPES[q.dtype],
                              torch.cuda.current_stream(q.device).cuda_stream),
              "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor,
                             causal: bool = True, window: int = 0):
    """The gradient of flash attention: ``(dq, dk, dv)`` in q's dtype and
    shapes of q, k, v, from the forward's inputs, its output ``o``, the
    output's gradient ``do`` (both ``(B, Sq, H, hd)``, q's dtype,
    contiguous, 16-byte aligned) and its ``lse`` (float32 ``(B, H, Sq)``),
    with the forward's ``window``.
    Two launches on the current stream: the dq kernel (which also writes
    each row's D = rowsum(do * o)), then the dk/dv kernel, which sums the
    group's query heads in the block: no atomics, the same bits every
    call.  hd must be in ``BWD_HEAD_DIMS``; raises on anything the kernels
    do not take."""
    b, sq, skv, h, kv, hd, _ = _check(q, k, v,
                                      tuple((d, d) for d in BWD_HEAD_DIMS),
                                      "flash_attention_bwd_cuda")
    window = _check_window(window, causal, sq, skv)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{q.dtype}{tuple(q.shape)} on {q.device}, got "
                             f"{t.dtype}{tuple(t.shape)} on {t.device}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(b, h, sq)} on "
                         f"{q.device}, got {lse.dtype}{tuple(lse.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    launch_dq, launch_dkdv = _bwd_launchers()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dims = (b, sq, skv, h, kv, hd, int(causal), window, hd ** -0.5,
            DTYPES[q.dtype], stream)
    _raise_on(launch_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        delta.data_ptr(), dq.data_ptr(), *dims),
              "flash_attention_bwd_dq")
    LAUNCHES["flash_attention_bwd_dq"] += 1
    _raise_on(launch_dkdv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          dk.data_ptr(), dv.data_ptr(), *dims),
              "flash_attention_bwd_dkdv")
    LAUNCHES["flash_attention_bwd_dkdv"] += 1
    return dq, dk, dv
