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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.parallel.api import (along_features, block_start, max_over,
                                      on_shards, sum_over)
from repro_torch.parallel.opcount import trips

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
    float32 operand against bfloat16 weights; torch's refuses the mix).
    DTensors are laid out first as XLA's partitioner lays out a dot
    (`_dot_layouts`)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    if isinstance(x, DTensor) and isinstance(w, DTensor):
        # each rank's product is its block of the result, or its part of a
        # sum over the ranks that split the contraction (a partial sum)
        xpl, wpl = _dot_layouts(x, w)
        opl = [Partial() if xp == Shard(x.ndim - 1) and wp == Shard(0)
               else Shard(x.ndim - 1) if wp == Shard(1) else xp
               for xp, wp in zip(xpl, wpl)]
        return on_shards(lambda a, b: (a.to(dt) @ b.to(dt),), x.device_mesh,
                         (x, w), (xpl, wpl), (opl,))[0]
    return x.to(dt) @ w.to(dt)


def _dot_layouts(x: DTensor, w: DTensor):
    """Placements of x (..., D) and a weight w (D, F) for their product,
    per mesh dim: where x's tokens are split, w is gathered (FSDP); else
    w split over F keeps x whole (column parallel), w split over D splits
    x over D (row parallel, a partial sum out), and so does x split over
    D against a whole w (whose rows each rank slices)."""
    xd = x.ndim - 1
    xpl, wpl = list(x.placements), list(w.placements)
    for i, (xp, wp) in enumerate(zip(xpl, wpl)):
        tokens = isinstance(xp, Shard) and xp.dim != xd
        if tokens:
            wpl[i] = Replicate()
        elif wp == Shard(1):
            xpl[i] = Replicate()
        elif wp == Shard(0):
            xpl[i] = Shard(xd)
        elif xp == Shard(xd):
            wpl[i] = Shard(0)
        elif xp.is_partial():
            xpl[i] = Replicate()
    return xpl, wpl


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
    y = y * along_features(p["scale"], y).float()
    if norm_type == "layernorm":
        y = y + along_features(p["bias"], y).float()
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
    if isinstance(x, DTensor):
        x = _whole_heads(x, 2, n_heads)
    return x.reshape(b, s, n_heads, head_dim)


def _whole_heads(x: DTensor, dim: int, n_heads: int) -> DTensor:
    """`x` with its feature dim `dim` (n_heads x head_dim) gathered on each
    mesh dim that would split a head: a shard must hold whole heads."""
    mesh, pl = x.device_mesh, list(x.placements)
    split = 1
    for i, p in enumerate(pl):
        if p == Shard(dim):
            if n_heads % (split * mesh.size(i)):
                pl[i] = Replicate()
            else:
                split *= mesh.size(i)
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


def blocked_attention(q, k, v, *, causal, q_offset=0, block=1024):
    """Flash-style streaming-softmax attention, blocked over KV.

    q: (B, Sq, H, D); k/v: (B, Skv, KV, D) with H % KV == 0.
    Returns (B, Sq, H, D). DTensors run shard by shard
    (`_blocked_attention_sharded`).
    """
    if isinstance(q, DTensor):
        return _blocked_attention_sharded(q, k, v, causal=causal,
                                          q_offset=q_offset, block=block)
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
    for j in trips(nblk):
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
    cache positions (including the token just written). DTensors run shard
    by shard (`_decode_attention_sharded`).
    """
    if isinstance(q, DTensor):
        return _decode_attention_sharded(q, k_cache, v_cache, cur_len)
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


# ---------------------------------------------------------------------------
# attention on DTensors: each rank runs the plain code on its blocks


def _head_placements(x: DTensor, kv: int):
    """Per mesh dim, how attention splits: "b" (batch), "h" (whole KV
    groups of heads), "s" (the query sequence) or None, from `x`'s
    placements (B, S, H, D). A mesh dim that splits the heads but not into
    whole KV groups splits the sequence instead, where it divides."""
    mesh = x.device_mesh
    out, split_h, split_s = [], 1, 1
    for i, p in enumerate(x.placements):
        n = mesh.size(i)
        if p == Shard(0):
            out.append("b")
        elif p == Shard(2) and kv % (split_h * n) == 0:
            split_h *= n
            out.append("h")
        elif p in (Shard(1), Shard(2)) and x.shape[1] % (split_s * n) == 0:
            split_s *= n
            out.append("s")
        else:
            out.append(None)
    return out


_AXIS = {"b": Shard(0), "h": Shard(2), "s": Shard(1), None: Replicate()}


def _blocked_attention_sharded(q, k, v, *, causal, q_offset, block):
    """Each rank attends its queries (its batch, heads and sequence block)
    to its batch's and heads' whole keys: sequence parallelism gathers the
    K/V (GQA's small tensors), not the queries."""
    mesh = q.device_mesh
    how = _head_placements(q, k.shape[2])
    qpl = [_AXIS[a] for a in how]
    kpl = [_AXIS[a if a != "s" else None] for a in how]

    def local(ql, kl, vl):
        off = q_offset + block_start(mesh, qpl, 1, ql.shape[1])
        return (blocked_attention(ql, kl, vl, causal=causal, q_offset=off,
                                  block=block),)

    return on_shards(local, mesh, (q, k, v), (qpl, kpl, kpl), (qpl,))[0]


def _decode_attention_sharded(q, k_cache, v_cache, cur_len):
    """Each rank attends its batch's and heads' query to its block of the
    cache; where the cache's sequence is split (flash-decoding), the
    softmax's max, its sum and the weighted values are reduced over the
    ranks that hold the other blocks."""
    mesh = k_cache.device_mesh
    cpl = list(k_cache.placements)
    seq_dims = [i for i, p in enumerate(cpl) if p == Shard(1)]
    qpl = [p if p in (Shard(0), Shard(2)) else Replicate() for p in cpl]

    def local(ql, kl, vl):
        if not seq_dims:
            return (decode_attention(ql, kl, vl, cur_len),)
        b, _, h, d = ql.shape
        n, kv = kl.shape[1], kl.shape[2]
        qf = ql.reshape(b, kv, h // kv, d).float()
        s = torch.einsum("bkgd,bckd->bkgc", qf, kl.float()) / math.sqrt(d)
        pos = block_start(mesh, cpl, 1, n) + torch.arange(n, device=ql.device)
        mask = (pos < cur_len)[None, None, None]
        s = torch.where(mask, s, -torch.inf)
        m = max_over(torch.amax(s, dim=-1), mesh, seq_dims)
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        l = sum_over(torch.sum(p, dim=-1), mesh, seq_dims)
        o = sum_over(torch.einsum("bkgc,bckd->bkgd", p, vl.float()), mesh,
                     seq_dims)
        out = o / l[..., None]
        return (out.reshape(b, 1, h, d).to(ql.dtype),)

    return on_shards(local, mesh, (q, k_cache, v_cache), (qpl, cpl, cpl),
                     (qpl,))[0]


def write_cache(buf, x, index):
    """`buf` with `x` written in place at sequence position `index` of
    axis 1 (dynamic_update_slice's semantics: the start is clamped so the
    slice fits). The caller passes the returned cache on and never reads
    the old one again. A DTensor `buf` is written shard by shard: each rank
    writes the part of `x` that falls in its block of axis 1."""
    start = max(0, min(int(index), buf.shape[1] - x.shape[1]))
    if isinstance(buf, DTensor):
        return _write_cache_sharded(buf, x, start)
    buf[:, start:start + x.shape[1]] = x.to(buf.dtype)
    return buf


def _write_cache_sharded(buf, x, start):
    mesh, pl = buf.device_mesh, tuple(buf.placements)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if x.shape[1] == buf.shape[1]:         # the whole cache (prefill)
        buf.to_local().copy_(x.to(buf.dtype).redistribute(mesh, pl)
                             .to_local())
        return buf
    # x in buf's layout, but whole along axis 1
    xl = x.to(buf.dtype).redistribute(
        mesh, [Replicate() if p == Shard(1) else p for p in pl]).to_local()
    local = buf.to_local()
    n = local.shape[1]
    lo = block_start(mesh, pl, 1, n)
    a, b = max(start, lo), min(start + xl.shape[1], lo + n)
    if a < b:
        local[:, a - lo:b - lo] = xl[:, a - start:b - start]
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


def embed(table, tokens):
    """The rows of `table` (V, D) at `tokens`: `F.embedding`. A DTensor
    table runs shard by shard: a rank whose block of the vocabulary holds
    a token gives its row, the others zeros (a partial sum over the ranks
    that split the vocabulary), and a table split over D where the tokens
    are split too is gathered first (FSDP)."""
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tpl, kpl, opl = [], [], []
    for t, k in zip(table.placements, tokens.placements):
        if t == Shard(0):                        # vocabulary
            tpl.append(t), kpl.append(Replicate()), opl.append(Partial())
        elif k == Shard(0):                      # tokens split: gather
            tpl.append(Replicate()), kpl.append(k), opl.append(Shard(0))
        elif t == Shard(1):
            tpl.append(t), kpl.append(Replicate()), opl.append(Shard(2))
        else:
            tpl.append(Replicate()), kpl.append(Replicate())
            opl.append(Replicate())

    def local(tl, kl):
        if Shard(0) not in tpl:
            return (F.embedding(kl, tl),)
        n = tl.shape[0]
        idx = kl - block_start(mesh, tpl, 0, n)
        hit = (idx >= 0) & (idx < n)
        rows = F.embedding(idx.clamp(0, n - 1), tl)
        return (rows * hit[..., None].to(rows.dtype),)

    return on_shards(local, mesh, (table, tokens), (tpl, kpl), (opl,))[0]


def init_embed(gen, vocab, dim, dtype):
    return {"table": _embed_init(gen, vocab, dim, dtype)}


def sinusoidal_positions(length, dim, device):
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(emb.astype(np.float32), device=device)
