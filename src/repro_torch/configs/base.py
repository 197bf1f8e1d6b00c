"""Architecture / shape config system.

One ``ModelConfig`` per assigned architecture (exact numbers from the
assignment table), one ``ShapeConfig`` per assigned input shape, and a
registry used by ``--arch`` selection in the launchers, the dry-run, the
smoke tests and the benchmarks.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Sequence

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    # apply MoE every `period` layers starting at `offset`; dense otherwise
    period: int = 1
    offset: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # experts are padded so EP degree divides the expert count
    ep_pad_to: int = 16

    @property
    def padded_experts(self) -> int:
        return _round_up(self.num_experts, self.ep_pad_to)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    variant: str = "mamba"  # "mamba" | "rwkv6"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64      # rwkv6 head size
    chunk_size: int = 128   # chunked-parallel scan block

    @property
    def d_inner_factor(self) -> int:
        return self.expand


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""
    # --- attention details ---
    rope_variant: str = "full"  # full | 2d (chatglm) | mrope (qwen2-vl) | none
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "swiglu"         # swiglu | gelu
    logit_softcap: float = 0.0
    tie_embeddings: bool = False
    # --- MoE / SSM / hybrid ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: which layers are attention (jamba: 1 attn per `attn_period`)
    attn_period: int = 1        # 1 => every layer is attention (or ssm if family==ssm)
    attn_offset: int = 0
    # --- encoder/decoder (whisper) ---
    encoder_layers: int = 0
    cross_attention: bool = False
    num_frames: int = 1500      # stub frontend output length (audio frames / vision patches)
    frontend: str = "none"      # none | audio_stub | vision_stub
    # --- dtypes ---
    param_dtype: str = "bfloat16"
    # optimizer choice for the 1T-class models
    factored_second_moment: bool = False
    opt_state_dtype: str = "float32"

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        # pad so TP=16 (and the 128-lane tile) always divides
        return _round_up(self.vocab_size, 16 * 128)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_period == 1:
            return True
        return i % self.attn_period == self.attn_offset

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return i % self.moe.period == self.moe.offset

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing => long_500k applies."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode step (whisper is enc-dec)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6ND)."""
        d, L = self.d_model, self.num_layers
        n = self.padded_vocab * d  # embedding
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        for i in range(L):
            if self.is_attn_layer(i):
                q = d * self.num_heads * self.head_dim
                kv = 2 * d * self.num_kv_heads * self.head_dim
                o = self.num_heads * self.head_dim * d
                n += q + kv + o
            elif self.ssm is not None:
                di = d * self.ssm.expand
                if self.ssm.variant == "rwkv6":
                    n += 5 * d * d + d * d  # r,k,v,g,o + w lora-ish (approx)
                else:
                    n += 2 * d * di + di * d + di * self.ssm.d_state * 2
            if self.is_moe_layer(i):
                e = self.moe.num_experts + self.moe.num_shared_experts
                mult = 3 if self.act == "swiglu" else 2
                n += e * mult * d * self.moe.d_ff_expert
                n += d * self.moe.num_experts  # router
            else:
                mult = 3 if self.act == "swiglu" else 2
                n += mult * d * self.d_ff
        for _ in range(self.encoder_layers):
            n += 4 * d * d + (3 if self.act == "swiglu" else 2) * d * self.d_ff
            if self.cross_attention:
                n += 4 * d * d  # decoder cross-attn blocks counted here
        return n

    def active_param_count(self) -> int:
        """Active (per-token) params — MoE counts only routed top-k + shared."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        n = self.param_count()
        # subtract inactive experts
        for i in range(L):
            if self.is_moe_layer(i):
                inactive = self.moe.num_experts - self.moe.top_k
                mult = 3 if self.act == "swiglu" else 2
                n -= inactive * mult * d * self.moe.d_ff_expert
        return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    mode: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

ARCH_IDS = (
    "tinyllama-1.1b",
    "stablelm-3b",
    "chatglm3-6b",
    "stablelm-12b",
    "rwkv6-3b",
    "kimi-k2-1t-a32b",
    "qwen2-moe-a2.7b",
    "jamba-v0.1-52b",
    "whisper-small",
    "qwen2-vl-2b",
)

_MODULES = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "stablelm-3b": "stablelm_3b",
    "chatglm3-6b": "chatglm3_6b",
    "stablelm-12b": "stablelm_12b",
    "rwkv6-3b": "rwkv6_3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "whisper-small": "whisper_small",
    "qwen2-vl-2b": "qwen2_vl_2b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE_CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def applicable_shapes(cfg: ModelConfig) -> Sequence[str]:
    out = []
    for s in SHAPE_NAMES:
        if s == "long_500k" and not cfg.supports_long_context:
            continue  # quadratic full attention at 524k — skipped per DESIGN.md
        out.append(s)
    return tuple(out)


def all_cells():
    """All 40 (arch, shape) cells; yields (arch, shape, applicable: bool)."""
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPE_NAMES:
            yield a, s, (s in applicable_shapes(cfg))
