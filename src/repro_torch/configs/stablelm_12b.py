"""StableLM-12B [hf:stabilityai/stablelm-2-1_6b; hf] — GQA kv=8, LayerNorm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense", num_layers=40, d_model=5120,
    num_heads=32, num_kv_heads=8, d_ff=13824, vocab_size=100352,
    rope_variant="full", norm="layernorm", act="swiglu",
    source="hf:stabilityai/stablelm-2-1_6b; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="stablelm-12b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
    rope_variant="full", norm="layernorm", act="swiglu",
)
