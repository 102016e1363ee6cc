"""stablelm-3b — dense, MHA, partial rotary, LayerNorm.
[hf:stabilityai/stablelm-2-1_6b; unverified] 32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304
"""
from repro_torch.configs.base import ModelConfig, ParallelSpec

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    head_dim=80,
    block_pattern=("attn",),
    norm="layernorm",
    partial_rotary_factor=0.25,
    rope_theta=10000.0,
    parallel=ParallelSpec(fsdp=False, opt_state_dtype="float32", remat=True,
                          sequence_parallel=True),
)
