"""ChatGLM3-6B [arXiv:2406.12793; hf] — 2d RoPE (rotary on half the head dim), GQA kv=2."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense", num_layers=28, d_model=4096,
    num_heads=32, num_kv_heads=2, d_ff=13696, vocab_size=65024,
    rope_variant="2d", norm="rmsnorm", act="swiglu",
    source="arXiv:2406.12793; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="chatglm3-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
    rope_variant="2d", norm="rmsnorm", act="swiglu",
)
