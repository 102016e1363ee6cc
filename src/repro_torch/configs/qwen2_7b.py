"""qwen2-7b — dense, GQA, QKV bias.
[arXiv:2407.10671; hf] 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064
"""
from repro_torch.configs.base import ModelConfig, ParallelSpec

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    block_pattern=("attn",),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    parallel=ParallelSpec(fsdp=False, opt_state_dtype="float32", remat=True,
                          sequence_parallel=True),
)
