"""Streaming-softmax (flash) attention: a CUDA kernel and its plain
version.

Causal or full attention over the grouped-query layout (q ``(B, Sq, H,
hd)``, k/v ``(B, Skv, KV, hd)``), the prefill attention of the LM's
``attn`` and ``local`` layers.  CUDA tensors run the kernel
(``csrc/flash_attention.cu``), CPU tensors the plain PyTorch version
(``ref.flash_attention_ref``).  Launches are counted in
``repro_torch.kernels.LAUNCHES["flash_attention"]``.  Its gradient
(``ops.FlashAttention``, taken when one is wanted) is the backward kernel
(``csrc/flash_attention_bwd.cu``, two launches, counted under
``"flash_attention_bwd_dq"`` and ``"flash_attention_bwd_dkdv"``) or
``ref.flash_attention_bwd_ref``.
"""
from repro_torch.kernels.flash_attention.ops import (FlashAttention,
                                                    flash_attention)
from repro_torch.kernels.flash_attention.ref import (
    attention_ref, flash_attention_bwd_ref, flash_attention_fwd_lse_ref,
    flash_attention_ref)

__all__ = ["FlashAttention", "attention_ref", "flash_attention",
           "flash_attention_bwd_ref", "flash_attention_fwd_lse_ref",
           "flash_attention_ref"]
