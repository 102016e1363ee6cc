"""The RWKV-6 WKV recurrence: a CUDA kernel and its plain version.

Linear attention with a data-dependent decay ``w`` and a bonus ``u`` for
the current token, over r, k, v, w ``(B, T, H, hd)`` in float32, the
prefill recurrence of the LM's ``rwkv`` layers.  ``wkv`` returns the
output and the final ``(B, H, hd, hd)`` state; CUDA tensors run the
kernel (``csrc/rwkv6_wkv.cu``), CPU tensors the plain PyTorch version
(``ref.wkv_ref``).  ``wkv_chunked`` takes the reference op's ``(BH, T,
hd)`` layout.  Launches are counted in
``repro_torch.kernels.LAUNCHES["rwkv6_wkv"]``.
"""
from repro_torch.kernels.rwkv6_wkv.ops import wkv, wkv_chunked
from repro_torch.kernels.rwkv6_wkv.ref import wkv_ref

__all__ = ["wkv", "wkv_chunked", "wkv_ref"]
