"""Qwen2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] — 4 shared + 60 routed top-4.

60 routed experts are padded to 64 for EP degree 16 (masked; see DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe", num_layers=24, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=151936,
    rope_variant="full", norm="rmsnorm", act="swiglu",
    moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                  num_shared_experts=4, ep_pad_to=16),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-moe-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=512,
    rope_variant="full", norm="rmsnorm", act="swiglu",
    moe=MoEConfig(num_experts=6, top_k=2, d_ff_expert=64,
                  num_shared_experts=2, ep_pad_to=1, capacity_factor=64.0),
)
