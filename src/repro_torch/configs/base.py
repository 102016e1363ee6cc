"""Config dataclasses of the LM scaffold: a copy of the reference's
``repro/configs/base.py``, which is pure Python, so that the port imports
nothing of the reference package.  Keep the two equal.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoESpec:
    """Mixture-of-experts block spec (GShard-style EP with colibri dispatch)."""
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 1
    capacity_factor: float = 1.25
    # Layer index at which MoE layers begin (earlier layers are dense).
    moe_layer_start: int = 1
    # d_ff used by the dense (non-MoE) leading layers.
    dense_d_ff: int = 0
    router_noise: float = 0.0
    # Aux load-balance loss weight.
    aux_loss_weight: float = 0.001


@dataclass(frozen=True)
class MLASpec:
    """Multi-head latent attention (DeepSeek-V3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class EncoderSpec:
    """Encoder stack for enc-dec models (whisper). Frontend is a stub:
    ``input_specs`` provides precomputed frame embeddings."""
    num_layers: int
    seq_len: int = 1500          # whisper: 30 s of audio -> 1500 frames


@dataclass(frozen=True)
class RecurrentSpec:
    """RG-LRU (recurrentgemma) / RWKV-6 recurrence parameters."""
    lru_width: int = 0           # rg-lru recurrent width (0 -> d_model)
    conv1d_width: int = 4        # temporal conv in the recurrent block
    head_dim: int = 64           # rwkv6 wkv head size


@dataclass(frozen=True)
class ParallelSpec:
    """Per-arch distribution policy."""
    fsdp: bool = False           # shard weights over the data axis too (ZeRO-3)
    opt_state_dtype: str = "float32"   # float32 | bfloat16 | int8
    remat: bool = True
    accum_steps: int = 1
    grad_accum_dtype: str = "float32"   # bfloat16 halves the accum buffer
    # Sequence-parallel residual path (hillclimb feature; see §Perf).
    sequence_parallel: bool = False


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    # Block pattern, cycled over layers. "attn" = full attn + mlp,
    # "local" = sliding-window attn + mlp, "rglru" = RG-LRU + mlp,
    # "rwkv" = rwkv6 time-mix + channel-mix.
    block_pattern: Tuple[str, ...] = ("attn",)
    local_window: int = 2048
    attn_kind: str = "gqa"       # gqa | mla
    qkv_bias: bool = False
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "silu"            # silu | gelu
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 1.0   # fraction of head_dim rotated
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    encoder: Optional[EncoderSpec] = None
    recurrent: Optional[RecurrentSpec] = None
    frontend: Optional[str] = None       # None | "audio" | "vlm"
    num_patches: int = 256               # vlm stub patch count
    parallel: ParallelSpec = field(default_factory=ParallelSpec)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, cycling block_pattern over num_layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def is_attention_free(self) -> bool:
        kinds = set(self.layer_kinds())
        return not (kinds & {"attn", "local"})

    def is_subquadratic(self) -> bool:
        """True if no full-attention layer (local windows / recurrence only)."""
        kinds = set(self.layer_kinds())
        return "attn" not in kinds

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                  # lm head
        def attn_params() -> int:
            if self.attn_kind == "mla":
                m = self.mla
                p = d * m.q_lora_rank
                p += m.q_lora_rank * nq * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * nq * (m.qk_nope_head_dim + m.v_head_dim)
                p += nq * m.v_head_dim * d
                return p
            return d * (nq + 2 * nkv) * hd + nq * hd * d
        def mlp_params(ff: int) -> int:
            mult = 3 if self.act == "silu" else 2         # gated vs plain
            return mult * d * ff
        for i, kind in enumerate(self.layer_kinds()):
            total += 2 * d                                # norms
            if kind in ("attn", "local"):
                total += attn_params()
                total += self._ff_params_for_layer(i, mlp_params)
            elif kind == "rglru":
                w = (self.recurrent.lru_width or d) if self.recurrent else d
                total += 2 * d * w + 2 * w + w * self.recurrent.conv1d_width + w * d
                total += mlp_params(self.d_ff)
            elif kind == "rwkv":
                total += 6 * d * d                        # time-mix r,k,v,g,o + decay
                total += 2 * d * self.d_ff                # channel mix
        if self.encoder is not None:
            e = self.encoder
            per = d * (nq + 2 * nq) * hd + nq * hd * d + 2 * d * self.d_ff + 4 * d
            total += e.num_layers * per
            total += e.seq_len * d                        # learned pos emb
            # cross-attention in every decoder layer
            total += self.num_layers * (d * (nq + 2 * nq) * hd + nq * hd * d + 2 * d)
        return total

    def _ff_params_for_layer(self, i: int, mlp_params) -> int:
        if self.moe is not None and i >= self.moe.moe_layer_start:
            m = self.moe
            p = self.d_model * m.num_experts                        # router
            p += m.num_experts * 3 * self.d_model * m.d_ff_expert   # routed
            p += m.num_shared_experts * 3 * self.d_model * m.d_ff_expert
            return p
        if self.moe is not None and self.moe.dense_d_ff:
            return mlp_params(self.moe.dense_d_ff)
        return mlp_params(self.d_ff)

    def num_active_params(self) -> int:
        """Parameters touched per token (MoE: only routed-to experts)."""
        if self.moe is None:
            return self.num_params()
        m = self.moe
        total = self.num_params()
        # subtract non-active routed experts
        n_moe_layers = sum(1 for i in range(self.num_layers) if i >= m.moe_layer_start)
        per_expert = 3 * self.d_model * m.d_ff_expert
        total -= n_moe_layers * (m.num_experts - m.top_k) * per_expert
        return total


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(applicable, reason). long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.is_subquadratic():
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md)"
    return True, ""


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 2 * len(cfg.block_pattern)),
        d_model=128,
        num_heads=4,
        num_kv_heads=(1 if cfg.num_kv_heads == 1
                      else 2 if cfg.num_kv_heads < cfg.num_heads else 4),
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        param_dtype="float32",
        compute_dtype="float32",
        parallel=ParallelSpec(fsdp=False, remat=False),
    )
    if cfg.num_kv_heads == 1:
        kw["num_kv_heads"] = 1
    if cfg.moe is not None:
        kw["moe"] = MoESpec(num_experts=8, top_k=2, d_ff_expert=64,
                            num_shared_experts=cfg.moe.num_shared_experts,
                            moe_layer_start=min(cfg.moe.moe_layer_start, 1),
                            dense_d_ff=256 if cfg.moe.dense_d_ff else 0)
    if cfg.mla is not None:
        kw["mla"] = MLASpec(q_lora_rank=64, kv_lora_rank=32,
                            qk_nope_head_dim=32, qk_rope_head_dim=16,
                            v_head_dim=32)
    if cfg.encoder is not None:
        kw["encoder"] = EncoderSpec(num_layers=2, seq_len=16)
    if cfg.recurrent is not None:
        kw["recurrent"] = RecurrentSpec(
            lru_width=128 if cfg.recurrent.lru_width else 0,
            conv1d_width=cfg.recurrent.conv1d_width,
            head_dim=32)
    kw["local_window"] = min(cfg.local_window, 64)
    kw["num_patches"] = min(cfg.num_patches, 8)
    return dataclasses.replace(cfg, **kw)
