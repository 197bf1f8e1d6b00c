"""Core NN primitives in torch ops: norms, RoPE variants, GQA attention with
blocked (flash-style) softmax, dense MLPs.

The port of src/repro/models/layers.py. Parameters are nested dicts of
tensors (or `ParamTree` modules that read the same way, `p["wq"]`); every
function computes what the reference's does, in the same order of
operations where the order decides a rounding: the streaming softmax keeps
its block loop, running max, fully-masked-row guard and f32 accumulators,
and decode attention its plain masked softmax. Neither calls
`scaled_dot_product_attention`, whose sums run in another order.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# init helpers (the reference's distributions; the stream is torch's)


def _normal(gen, shape, scale):
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def _dense_init(gen, in_dim, out_dim, dtype):
    return _normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim)).to(dtype)


def _embed_init(gen, vocab, dim, dtype):
    return _normal(gen, (vocab, dim), 0.02).to(dtype)


def mm(x, w):
    """x @ w in the promoted dtype of the two (jnp's matmul promotes a
    float32 operand against bfloat16 weights; torch's refuses the mix)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------------
# norms


def init_norm(dim, norm_type, dtype, device):
    p = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def apply_norm(p, x, norm_type, eps=1e-5):
    xf = x.float()
    if norm_type == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    else:
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if norm_type == "layernorm":
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE variants
#   full  : rotate the whole head_dim (llama)
#   2d    : rotate only the first half of head_dim (chatglm-style 2d rope)
#   mrope : qwen2-vl multimodal rope — head_dim split in sections rotated
#           with (temporal, height, width) position streams


def _rope_angles(positions, rot_dim, theta):
    """positions (..., S) -> (..., S, rot_dim/2) angles."""
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=positions.device) / rot_dim
    inv = 1.0 / (theta ** exps)
    return positions[..., None].float() * inv


def _rotate(x, angles):
    """x (..., S, H, rot_dim) with angles (..., S, rot_dim/2)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x, positions, variant, theta=10000.0,
               mrope_sections=(16, 24, 24)):
    """x: (B, S, H, D). positions: (B, S) int or (3, B, S) for mrope."""
    if variant == "none":
        return x
    d = x.shape[-1]
    if variant == "full":
        ang = _rope_angles(positions, d, theta)              # (B,S,d/2)
        return _rotate(x, ang).to(x.dtype)
    if variant == "2d":
        rot = d // 2
        xr, xp = x[..., :rot], x[..., rot:]
        ang = _rope_angles(positions, rot, theta)
        return torch.cat([_rotate(xr, ang).to(x.dtype), xp], dim=-1)
    if variant == "mrope":
        # positions: (3, B, S); sections over half-dims, scaled as the
        # reference scales qwen2-vl's (16, 24, 24) for other head dims
        half = d // 2
        secs = list(mrope_sections)
        if sum(secs) != half:
            t = max(1, half // 4)
            h = (half - t) // 2
            secs = [t, h, half - t - h]
        ang_full = _rope_angles(positions, d, theta)          # (3,B,S,half)
        parts, off = [], 0
        for i, s in enumerate(secs):
            parts.append(ang_full[i, ..., off:off + s])
            off += s
        ang = torch.cat(parts, dim=-1)                        # (B,S,half)
        return _rotate(x, ang).to(x.dtype)
    raise ValueError(variant)


# ---------------------------------------------------------------------------
# attention


def init_attention(gen, cfg, dtype):
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": _dense_init(gen, d, cfg.num_heads * hd, dtype),
        "wk": _dense_init(gen, d, cfg.num_kv_heads * hd, dtype),
        "wv": _dense_init(gen, d, cfg.num_kv_heads * hd, dtype),
        "wo": _dense_init(gen, cfg.num_heads * hd, d, dtype),
    }


def _split_heads(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def blocked_attention(q, k, v, *, causal, q_offset=0, block=1024):
    """Flash-style streaming-softmax attention, blocked over KV.

    q: (B, Sq, H, D); k/v: (B, Skv, KV, D) with H % KV == 0.
    Returns (B, Sq, H, D).
    """
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.reshape(b, sq, kv, g, d).float()
    scale = 1.0 / math.sqrt(d)
    dev = q.device

    nblk = (skv + block - 1) // block
    pad = nblk * block - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = q_offset + torch.arange(sq, device=dev)

    acc = torch.zeros((b, kv, g, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, kv, g, sq), -torch.inf, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=dev)
    for j in range(nblk):
        kj = k[:, j * block:(j + 1) * block].float()
        vj = v[:, j * block:(j + 1) * block].float()
        kv_pos = j * block + torch.arange(block, device=dev)
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, kj) * scale
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((sq, block), dtype=torch.bool, device=dev)
        mask = mask & (kv_pos < skv)[None, :]
        s = torch.where(mask[None, None, None], s, -torch.inf)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # guard fully-masked rows
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask[None, None, None], p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd", p, vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.movedim(out, 3, 1).reshape(b, sq, h, d)
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cur_len):
    """Single-token attention against a KV cache.

    q: (B, 1, H, D); caches: (B, Smax, KV, D); cur_len: number of valid
    cache positions (including the token just written).
    """
    b, _, h, d = q.shape
    smax, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    qf = q.reshape(b, kv, g, d).float()
    s = torch.einsum("bkgd,bckd->bkgc", qf, k_cache.float())
    s = s / math.sqrt(d)
    mask = torch.arange(smax, device=q.device) < cur_len
    s = torch.where(mask[None, None, None], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def write_cache(buf, x, index):
    """`buf` with `x` written in place at sequence position `index` of
    axis 1 (dynamic_update_slice's semantics: the start is clamped so the
    slice fits). The caller passes the returned cache on and never reads
    the old one again."""
    start = max(0, min(int(index), buf.shape[1] - x.shape[1]))
    buf[:, start:start + x.shape[1]] = x.to(buf.dtype)
    return buf


def attention_apply(p, x, cfg, *, positions, cache=None, cache_index=None,
                    kv_override=None, causal=True):
    """GQA attention. Returns (out, new_cache).

    cache: None (train/prefill, no cache kept) or dict(k, v) of
    (B, Smax, KV, D) — decode writes at `cache_index` then attends.
    kv_override: (k, v) already-projected cross-attention KV (whisper).
    """
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = _split_heads(mm(x, p["wq"]), cfg.num_heads, hd)
    if kv_override is None:
        k = _split_heads(mm(x, p["wk"]), cfg.num_kv_heads, hd)
        v = _split_heads(mm(x, p["wv"]), cfg.num_kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_variant, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_variant, cfg.rope_theta)
    else:
        k, v = kv_override

    if cache is not None and kv_override is None:
        # decode: write this token's kv into the cache at cache_index
        kc = write_cache(cache["k"], k, cache_index)
        vc = write_cache(cache["v"], v, cache_index)
        extra = {"k": kc, "v": vc}
        out = decode_attention(q, kc, vc, cache_index + 1)
    elif cache is not None:
        out = decode_attention(q, k, v, k.shape[1])  # cross-attn, full source
        extra = cache
    else:
        out = blocked_attention(q, k, v, causal=causal)
        extra = {"k": k, "v": v}  # projected kv, so prefill can fill a cache
    out = out.reshape(b, s, cfg.num_heads * hd)
    return mm(out, p["wo"]), extra


# ---------------------------------------------------------------------------
# MLPs


def init_mlp(gen, d_model, d_ff, act, dtype):
    if act == "swiglu":
        return {
            "wi": _dense_init(gen, d_model, d_ff, dtype),
            "wg": _dense_init(gen, d_model, d_ff, dtype),
            "wo": _dense_init(gen, d_ff, d_model, dtype),
        }
    return {
        "wi": _dense_init(gen, d_model, d_ff, dtype),
        "wo": _dense_init(gen, d_ff, d_model, dtype),
    }


def apply_mlp(p, x, act):
    if act == "swiglu":
        h = F.silu(mm(x, p["wg"])) * (mm(x, p["wi"]))
    elif act == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(mm(x, p["wi"]), approximate="tanh")
    elif act == "relu2":
        h = torch.square(F.relu(mm(x, p["wi"])))
    else:
        raise ValueError(act)
    return mm(h, p["wo"])


# ---------------------------------------------------------------------------
# embeddings


def init_embed(gen, vocab, dim, dtype):
    return {"table": _embed_init(gen, vocab, dim, dtype)}


def sinusoidal_positions(length, dim, device):
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(emb.astype(np.float32), device=device)
