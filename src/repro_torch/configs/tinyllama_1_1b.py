"""TinyLlama-1.1B [arXiv:2401.02385; hf] — llama2-arch small."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense", num_layers=22, d_model=2048,
    num_heads=32, num_kv_heads=4, d_ff=5632, vocab_size=32000,
    rope_variant="full", norm="rmsnorm", act="swiglu",
    source="arXiv:2401.02385; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="tinyllama-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
    rope_variant="full", norm="rmsnorm", act="swiglu",
)
