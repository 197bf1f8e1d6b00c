"""Whisper-small [arXiv:2212.04356; unverified] — enc-dec; conv frontend is a STUB
(input_specs supplies precomputed 1500-frame embeddings). Decode shapes exercise
the decoder + cross-attention KV cache.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=51865,
    rope_variant="none", norm="layernorm", act="gelu",
    encoder_layers=12, cross_attention=True, num_frames=1500,
    frontend="audio_stub",
    source="arXiv:2212.04356; unverified",
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-smoke", family="audio", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
    rope_variant="none", norm="layernorm", act="gelu",
    encoder_layers=2, cross_attention=True, num_frames=16,
    frontend="audio_stub",
)
