"""RWKV6-3B (Finch) [arXiv:2404.05892; hf] — attention-free, data-dependent decay.

head size 64 => 40 heads at d_model=2560; channel-mix d_ff=8960 (relu^2).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm", num_layers=32, d_model=2560,
    num_heads=40, num_kv_heads=40, d_ff=8960, vocab_size=65536,
    rope_variant="none", norm="layernorm", act="relu2",
    ssm=SSMConfig(variant="rwkv6", head_dim=64, chunk_size=32),
    source="arXiv:2404.05892; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="rwkv6-smoke", family="ssm", num_layers=2, d_model=64,
    num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=512,
    rope_variant="none", norm="layernorm", act="relu2",
    ssm=SSMConfig(variant="rwkv6", head_dim=32, chunk_size=16),
)
