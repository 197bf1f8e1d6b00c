"""Kimi-K2-1T-A32B [arXiv:2501.kimi2; unverified] — trillion-param MoE, 384e top-8.

Assignment specifies GQA kv=8 (real K2 uses MLA — we follow the assignment; see
DESIGN.md). 61L x 384e x 3 x 7168 x 2048 ~ 1.03T expert params. 1 shared expert
per the public K2 spec. Optimizer: factored second moment + bf16 state so the
1T-state fits 16 GB/chip on the 512-chip mesh.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", num_layers=61, d_model=7168,
    num_heads=64, num_kv_heads=8, d_ff=2048, vocab_size=163840,
    rope_variant="full", norm="rmsnorm", act="swiglu",
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, ep_pad_to=16),
    factored_second_moment=True, opt_state_dtype="bfloat16",
    source="arXiv:2501.kimi2; unverified",
)

SMOKE_CONFIG = ModelConfig(
    name="kimi-k2-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=512,
    rope_variant="full", norm="rmsnorm", act="swiglu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                  num_shared_experts=1, ep_pad_to=1, capacity_factor=64.0),
    factored_second_moment=True, opt_state_dtype="bfloat16",
)
