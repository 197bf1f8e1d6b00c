"""StableLM-3B [hf:stabilityai/stablelm-2-1_6b; unverified] — MHA (kv=32), LayerNorm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense", num_layers=32, d_model=2560,
    num_heads=32, num_kv_heads=32, d_ff=6912, vocab_size=50304,
    rope_variant="full", norm="layernorm", act="swiglu",
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)

SMOKE_CONFIG = ModelConfig(
    name="stablelm-3b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
    rope_variant="full", norm="layernorm", act="swiglu",
)
