"""recurrentgemma-2b — RG-LRU + local attention, 1:2 pattern (Griffin).
Sub-quadratic: runs long_500k.
[arXiv:2402.19427; hf] 26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000
"""
from repro_torch.configs.base import ModelConfig, ParallelSpec, RecurrentSpec

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,               # pattern rglru,rglru,local cycled (1:2 attn:rnn)
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    act="gelu",
    recurrent=RecurrentSpec(lru_width=2560, conv1d_width=4),
    rope_theta=10000.0,
    parallel=ParallelSpec(fsdp=False, opt_state_dtype="float32", remat=True,
                          sequence_parallel=True),
)
