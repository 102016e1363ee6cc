"""kimi-k2-1t-a32b — trillion-param MoE (paper-table config).
Per the assigned table: GQA kv=8 (the real model is MLA-based; we follow the
assigned table — see DESIGN.md §Arch-applicability). 384 routed experts top-8,
1 shared expert, first layer dense.
[arXiv:2501.kimi2; unverified] 61L d_model=7168 64H (GQA kv=8) d_ff(expert)=2048 vocab=163840
"""
from repro_torch.configs.base import MoESpec, ModelConfig, ParallelSpec

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,                   # routed expert d_ff
    vocab_size=163840,
    head_dim=112,                # 7168 / 64
    block_pattern=("attn",),
    moe=MoESpec(num_experts=384, top_k=8, d_ff_expert=2048,
                num_shared_experts=1, capacity_factor=1.25,
                moe_layer_start=1, dense_d_ff=18432),
    rope_theta=50000.0,
    parallel=ParallelSpec(fsdp=True, opt_state_dtype="int8", remat=True,
                          accum_steps=8,
                          grad_accum_dtype="bfloat16"),
)
