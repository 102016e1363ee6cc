"""rwkv6-1.6b — "Finch": attention-free, data-dependent decay.
Sub-quadratic: runs long_500k.
[arXiv:2404.05892; unverified] 24L d_model=2048 d_ff=7168 vocab=65536
"""
from repro_torch.configs.base import ModelConfig, ParallelSpec, RecurrentSpec

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,                # wkv heads = d_model / head_dim
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    head_dim=64,
    block_pattern=("rwkv",),
    norm="layernorm",
    recurrent=RecurrentSpec(head_dim=64),
    # NOTE §Perf: sequence_parallel cut collectives 2.9x here but tripled
    # peak HBM (gathered recurrent states); head-sharded wkv via shard_map
    # is the right fix (future work) — SP stays OFF for this arch.
    parallel=ParallelSpec(fsdp=False, opt_state_dtype="float32", remat=True),
)
