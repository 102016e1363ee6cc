"""whisper-large-v3 — encoder-decoder; conv frontend is a STUB
(input_specs() provides precomputed 1500-frame encoder embeddings).
[arXiv:2212.04356; unverified] 32L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866
"""
from repro_torch.configs.base import EncoderSpec, ModelConfig, ParallelSpec

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,               # decoder layers; encoder below
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    block_pattern=("attn",),
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    partial_rotary_factor=0.0,   # whisper uses learned/sinusoidal positions
    encoder=EncoderSpec(num_layers=32, seq_len=1500),
    frontend="audio",
    parallel=ParallelSpec(fsdp=False, opt_state_dtype="float32", remat=True),
)
