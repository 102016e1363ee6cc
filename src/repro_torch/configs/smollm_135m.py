"""smollm-135m — llama-arch small dense LM.
[hf:HuggingFaceTB/SmolLM-135M; hf] 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
"""
from repro_torch.configs.base import ModelConfig, ParallelSpec

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    head_dim=64,
    block_pattern=("attn",),
    tie_embeddings=True,
    rope_theta=10000.0,
    parallel=ParallelSpec(fsdp=False, opt_state_dtype="float32", remat=True,
                          sequence_parallel=True),
)
