"""Jamba-v0.1-52B [arXiv:2403.19887; hf] — Mamba+attn 1:7 interleave, MoE 16e top-2.

Layer i is attention iff i % 8 == 4 (1:7 ratio, matching the released model);
MoE replaces the MLP on every second layer (i % 2 == 1).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=65536,
    rope_variant="none", norm="rmsnorm", act="swiglu",
    attn_period=8, attn_offset=4,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                  period=2, offset=1, ep_pad_to=16),
    ssm=SSMConfig(variant="mamba", d_state=16, d_conv=4, expand=2, chunk_size=128),
    source="arXiv:2403.19887; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="jamba-smoke", family="hybrid", num_layers=4, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
    rope_variant="none", norm="rmsnorm", act="swiglu",
    attn_period=2, attn_offset=1,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                  period=2, offset=1, ep_pad_to=1, capacity_factor=64.0),
    ssm=SSMConfig(variant="mamba", d_state=8, d_conv=4, expand=2, chunk_size=16),
)
