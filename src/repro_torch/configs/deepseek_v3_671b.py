"""deepseek-v3-671b — MoE flagship for the colibri dispatch technique.
MLA attention, 1 shared + 256 routed experts, top-8; first 3 layers dense.
MTP head omitted from step math (noted in DESIGN.md).
[arXiv:2412.19437; hf] 61L d_model=7168 128H d_ff(expert)=2048 vocab=129280
"""
from repro_torch.configs.base import MLASpec, MoESpec, ModelConfig, ParallelSpec

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=2048,                   # routed expert d_ff (per assigned table)
    vocab_size=129280,
    head_dim=128,
    block_pattern=("attn",),
    attn_kind="mla",
    mla=MLASpec(q_lora_rank=1536, kv_lora_rank=512,
                qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoESpec(num_experts=256, top_k=8, d_ff_expert=2048,
                num_shared_experts=1, capacity_factor=1.25,
                moe_layer_start=3, dense_d_ff=18432),
    rope_theta=10000.0,
    parallel=ParallelSpec(fsdp=True, opt_state_dtype="int8", remat=True,
                          accum_steps=8,
                          grad_accum_dtype="bfloat16"),
)
