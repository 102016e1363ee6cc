"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend (STUB: patch
embeddings come precomputed via input_specs()).
[hf:microsoft/Phi-3-vision-128k-instruct; hf] 32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064
"""
from repro_torch.configs.base import ModelConfig, ParallelSpec

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    block_pattern=("attn",),
    frontend="vlm",
    num_patches=256,
    rope_theta=10000.0,
    parallel=ParallelSpec(fsdp=False, opt_state_dtype="float32", remat=True,
                          sequence_parallel=True),
)
