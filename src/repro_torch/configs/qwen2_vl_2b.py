"""Qwen2-VL-2B [arXiv:2409.12191; hf] — M-RoPE (temporal/height/width), GQA kv=2.
Vision frontend is a STUB (input_specs supplies patch embeddings + 3-part
position ids). Backbone only, per the assignment.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm", num_layers=28, d_model=1536,
    num_heads=12, num_kv_heads=2, d_ff=8960, vocab_size=151936,
    rope_variant="mrope", norm="rmsnorm", act="swiglu",
    frontend="vision_stub", num_frames=256,
    source="arXiv:2409.12191; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-vl-smoke", family="vlm", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
    rope_variant="mrope", norm="rmsnorm", act="swiglu",
    frontend="vision_stub", num_frames=16,
)
