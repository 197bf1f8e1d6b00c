"""Attention-free sequence mixers: RWKV6 (Finch) and Mamba selective scan.

The port of src/repro/models/ssm.py. Both keep the reference's chunked
form: within a chunk the recurrence is evaluated with dense products, and a
loop over chunks carries the recurrent state.

- RWKV6 rescales keys by exp(-cumsum log decay) inside a chunk, with the
  cumsum clamped at +/- `_LOG_CLIP` (safe in f32), exactly as the
  reference does.
- Mamba's chunk scan is a linear-space recurrence h_t = a_t h_{t-1} + b_t
  (the reference's `jax.lax.associative_scan`): here a running product of
  the decays and a sequential scan over the chunk, never a log-space
  cumsum, which would break the decay ratios where the products underflow.

The `s == 1` decode steps are the plain recurrences and agree with the
chunked path (the decode-vs-prefill check).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.layers import (_dense_init, _normal, _split_heads,
                                       apply_norm, init_norm, mm)
from repro_torch.parallel.api import along_features, on_shards, reduced
from repro_torch.parallel.opcount import trips, unfold

_LOG_CLIP = 60.0


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================


def init_rwkv6(gen, cfg, dtype):
    d = cfg.d_model
    hk = cfg.ssm.head_dim
    h = d // hk
    lora = max(32, d // 32)
    dev = gen.device

    def full(v, dt=dtype):
        return torch.full((d,), v, dtype=dt, device=dev)

    return {
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
        "mu_g": full(0.5), "mu_w": full(0.5),
        "wr": _dense_init(gen, d, d, dtype),
        "wk": _dense_init(gen, d, d, dtype),
        "wv": _dense_init(gen, d, d, dtype),
        "wg": _dense_init(gen, d, d, dtype),
        "wo": _dense_init(gen, d, d, dtype),
        "w_base": full(-1.0, torch.float32),
        "lora_a": _dense_init(gen, d, lora, dtype),
        "lora_b": _normal(gen, (lora, d), 0.01).to(dtype),
        "u": _normal(gen, (h, hk), 0.1),
        "ln_x": init_norm(d, "layernorm", dtype, dev),
        # channel mix
        "cm_mu_k": full(0.5), "cm_mu_r": full(0.5),
        "cm_wk": _dense_init(gen, d, cfg.d_ff, dtype),
        "cm_wv": _dense_init(gen, cfg.d_ff, d, dtype),
        "cm_wr": _dense_init(gen, d, d, dtype),
    }


def _shift(x, prev):
    """Token shift: x_{t-1}; prev (B, D) is the last token of the previous
    segment (zeros at sequence start)."""
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _chunked_wkv(r, k, v, w, u, state, chunk):
    """r/k/w: (B,S,H,K) f32; v: (B,S,H,V) f32; w in (0,1); u: (H,K).
    state: (B,H,K,V). Returns (out (B,S,H,V), new_state)."""
    b, s, h, kk = r.shape
    vv = v.shape[-1]
    n = s // chunk
    rc = r.reshape(b, n, chunk, h, kk)
    kc = k.reshape(b, n, chunk, h, kk)
    vc = v.reshape(b, n, chunk, h, vv)
    lw = torch.log(torch.clamp(w, 1e-8, 1.0)).reshape(b, n, chunk, h, kk)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    S = state
    outs = []
    for j in trips(n):
        rj, kj, vj, lwj = rc[:, j], kc[:, j], vc[:, j], lw[:, j]
        cum = torch.cumsum(lwj, dim=1)             # inclusive log-decay prods
        cum = torch.clamp(cum, -_LOG_CLIP, 0.0)
        c_excl = torch.exp(cum - lwj)              # prod of w_1..w_{t-1}
        r_t = rj * c_excl
        k_t = kj * torch.exp(-cum)
        inter = torch.einsum("bchk,bhkv->bchv", r_t, S)
        att = torch.einsum("bchk,bdhk->bhcd", r_t, k_t)
        att = att * causal[None, None]
        intra = torch.einsum("bhcd,bdhv->bchv", att, vj)
        bonus = torch.einsum("bchk,hk,bchk->bch", rj, u, kj)
        outs.append(inter + intra + bonus[..., None] * vj)
        c_last = torch.exp(cum[:, -1])             # (B,H,K)
        S = c_last[..., None] * (S + torch.einsum("bchk,bchv->bhkv", k_t, vj))
    out = torch.stack(unfold(outs, n), dim=1).reshape(b, s, h, vv)
    return out, S


def _wkv(rh, kh, vh, wh, u, S, chunk):
    """The WKV recurrence over (B,S,H,K) inputs from state S (B,H,K,V):
    the plain recurrence for one token, else the chunked form."""
    if rh.shape[1] == 1:  # decode step: plain recurrence
        kv = torch.einsum("bhk,bhv->bhkv", kh[:, 0], vh[:, 0])
        out = torch.einsum("bhk,bhkv->bhv", rh[:, 0],
                           S + u[..., None] * kv)
        S = wh[:, 0][..., None] * S + kv
        return out[:, None], S
    return _chunked_wkv(rh, kh, vh, wh, u, S, chunk)


def _wkv_sharded(rh, kh, vh, wh, u, S, chunk):
    """`_wkv` on DTensors, each rank on its batch and heads, or, where the
    heads do not divide, on its columns of V (the recurrence is linear in
    v, column by column, as the cache rule splits the state); the
    sequence is whole on every rank."""
    mesh, h, vv = rh.device_mesh, rh.shape[2], vh.shape[3]
    spl_in = S.placements if isinstance(S, DTensor) else [None] * mesh.ndim
    rpl, vpl, upl, spl = [], [], [], []
    split_h = split_v = 1
    for i, (pl, sp) in enumerate(zip(rh.placements, spl_in)):
        n = mesh.size(i)
        cut = pl in (Shard(1), Shard(2)) or sp in (Shard(1), Shard(3))
        if pl == Shard(0):
            rpl.append(Shard(0)), vpl.append(Shard(0))
            upl.append(Replicate()), spl.append(Shard(0))
        elif cut and h % (split_h * n) == 0:
            split_h *= n
            rpl.append(Shard(2)), vpl.append(Shard(2))
            upl.append(Shard(0)), spl.append(Shard(1))
        elif cut and vv % (split_v * n) == 0:
            split_v *= n
            rpl.append(Replicate()), vpl.append(Shard(3))
            upl.append(Replicate()), spl.append(Shard(3))
        else:
            rpl.append(Replicate()), vpl.append(Replicate())
            upl.append(Replicate()), spl.append(Replicate())
    return on_shards(lambda r, k, v, w, uu, ss: _wkv(r, k, v, w, uu, ss,
                                                    chunk),
                     mesh, (rh, kh, vh, wh, u, S),
                     (rpl, rpl, vpl, rpl, upl, spl), (vpl, spl))


def rwkv6_time_mix(p, x, cfg, state):
    """state: dict(shift (B,D), wkv (B,H,K,V)). Returns (out, new_state)."""
    b, s, d = x.shape
    hk = cfg.ssm.head_dim
    h = d // hk
    xprev = (_shift(x, state["shift"]) if s > 1
             else state["shift"][:, None, :].to(x.dtype))

    def mix(mu):
        return x + (xprev - x) * along_features(mu, x)

    r = mm(mix(p["mu_r"]), p["wr"])
    k = mm(mix(p["mu_k"]), p["wk"])
    v = mm(mix(p["mu_v"]), p["wv"])
    g = mm(mix(p["mu_g"]), p["wg"])
    # Finch data-dependent decay
    dw = mm(torch.tanh(reduced(mm(mix(p["mu_w"]), p["lora_a"]))),
            p["lora_b"])
    w = torch.exp(-torch.exp(along_features(p["w_base"], dw)
                             + dw.float()))                 # (B,S,D)

    rh = _split_heads(r, h, hk).float()
    kh = _split_heads(k, h, hk).float()
    vh = _split_heads(v, h, hk).float()
    wh = _split_heads(w, h, hk)

    chunk = min(cfg.ssm.chunk_size, s)
    assert s % chunk == 0, (s, chunk)
    if isinstance(rh, DTensor):
        out, S = _wkv_sharded(rh, kh, vh, wh, p["u"], state["wkv"], chunk)
        # the heads' V columns whole again before they merge into D
        out = out.redistribute(out.device_mesh, [
            Replicate() if pl == Shard(3) else pl for pl in out.placements])
    else:
        out, S = _wkv(rh, kh, vh, wh, p["u"], state["wkv"], chunk)

    out = out.reshape(b, s, d).to(x.dtype)
    out = apply_norm(p["ln_x"], out, "layernorm")
    out = mm(out * F.silu(g), p["wo"])
    return out, {"shift": x[:, -1, :], "wkv": S}


def rwkv6_channel_mix(p, x, state):
    """state: shift (B, D)."""
    s = x.shape[1]
    xprev = (_shift(x, state) if s > 1 else state[:, None, :].to(x.dtype))
    xk = x + (xprev - x) * along_features(p["cm_mu_k"], x)
    xr = x + (xprev - x) * along_features(p["cm_mu_r"], x)
    k = torch.square(F.relu(mm(xk, p["cm_wk"])))
    out = torch.sigmoid(mm(xr, p["cm_wr"])) * mm(k, p["cm_wv"])
    return out, x[:, -1, :]


def rwkv6_state_init(cfg, batch, device, dtype=torch.float32):
    d = cfg.d_model
    hk = cfg.ssm.head_dim
    h = d // hk
    return {
        "shift_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "shift_cm": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, h, hk, hk), dtype=torch.float32,
                           device=device),
    }


# ===========================================================================
# Mamba (selective scan, as used in Jamba)
# ===========================================================================


def init_mamba(gen, cfg, dtype):
    d = cfg.d_model
    di = d * cfg.ssm.expand
    n = cfg.ssm.d_state
    dtr = max(1, math.ceil(d / 16))
    dev = gen.device
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": _dense_init(gen, d, 2 * di, dtype),
        "conv_w": _normal(gen, (cfg.ssm.d_conv, di), 0.1).to(dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": _dense_init(gen, di, dtr + 2 * n, dtype),
        "dt_proj": _dense_init(gen, dtr, di, dtype),
        "dt_bias": torch.zeros((di,), dtype=torch.float32, device=dev),
        "a_log": torch.log(a.repeat(di, 1)),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": _dense_init(gen, di, d, dtype),
    }


def _causal_conv(x, w, b, conv_state):
    """Depthwise causal conv. x (B,S,Di), w (K,Di), conv_state (B,K-1,Di)."""
    kk = w.shape[0]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(kk))
    new_state = xp[:, -(kk - 1):, :] if kk > 1 else conv_state
    return out + b, new_state


def _linear_scan(decay, inc, h0):
    """States h_t = decay_t * h_{t-1} + inc_t over axis 1 from h0, as the
    reference's associative scan composes them: the prefix products of the
    decays times h0, plus the scan of the increments from zero."""
    pd = torch.cumprod(decay, dim=1)
    pi = torch.empty_like(inc)
    acc = inc[:, 0]
    pi[:, 0] = acc
    for t in trips(inc.shape[1] - 1):
        t += 1
        acc = decay[:, t] * acc + inc[:, t]
        pi[:, t] = acc
    return pd * h0[:, None] + pi


def _selective_scan(dt, b_ssm, c_ssm, xf, a, h, chunk):
    """The selective scan of dt, x (B,S,Di), B and C (B,S,N) with a
    (Di,N) from state h (B,Di,N): (y (B,S,Di), last state)."""
    s = dt.shape[1]
    if s == 1:
        decay = torch.exp(dt[:, 0][..., None] * a)             # (B,Di,N)
        inc = (dt[:, 0] * xf[:, 0])[..., None] * b_ssm[:, 0][:, None, :]
        h = decay * h + inc
        return torch.einsum("bdn,bn->bd", h, c_ssm[:, 0])[:, None], h
    ys = []
    for j in trips(s // chunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        dt_j, b_j, c_j, x_j = dt[:, sl], b_ssm[:, sl], c_ssm[:, sl], \
            xf[:, sl]
        decay = torch.exp(dt_j[..., None] * a)              # (B,C,Di,N)
        inc = (dt_j * x_j)[..., None] * b_j[:, :, None, :]
        hs = _linear_scan(decay, inc, h)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, c_j))
        h = hs[:, -1]
    return torch.cat(unfold(ys, s // chunk), dim=1), h


def _selective_scan_sharded(dt, b_ssm, c_ssm, xf, a, h, chunk):
    """`_selective_scan` on DTensors, each rank on its batch and channels,
    the sequence whole on every rank."""
    mesh = dt.device_mesh
    xpl, bpl, apl, hpl = [], [], [], []
    for pl in dt.placements:
        if pl == Shard(0):
            xpl.append(Shard(0)), bpl.append(Shard(0))
            apl.append(Replicate()), hpl.append(Shard(0))
        elif pl == Shard(2):
            xpl.append(Shard(2)), bpl.append(Replicate())
            apl.append(Shard(0)), hpl.append(Shard(1))
        else:
            xpl.append(Replicate()), bpl.append(Replicate())
            apl.append(Replicate()), hpl.append(Replicate())
    return on_shards(lambda *t: _selective_scan(*t, chunk), mesh,
                     (dt, b_ssm, c_ssm, xf, a, h),
                     (xpl, bpl, bpl, xpl, apl, hpl), (xpl, hpl))


def mamba_mix(p, x, cfg, state):
    """state: dict(conv (B,K-1,Di), ssm (B,Di,N)). Returns (out, new_state)."""
    b, s, d = x.shape
    di = d * cfg.ssm.expand
    n = cfg.ssm.d_state
    dtr = p["dt_proj"].shape[0]

    xz = mm(x, p["in_proj"])
    xh, z = torch.chunk(xz, 2, dim=-1)
    xh, conv_state = _causal_conv(xh, along_features(p["conv_w"], xh),
                                  along_features(p["conv_b"], xh),
                                  state["conv"])
    xh = F.silu(xh)

    dbc = mm(xh, p["x_proj"])
    dt = reduced(mm(dbc[..., :dtr].float(), p["dt_proj"].float()),
                 like=p["dt_bias"])
    dt = F.softplus(dt + along_features(p["dt_bias"], dt))
    b_ssm = dbc[..., dtr:dtr + n].float()
    c_ssm = dbc[..., dtr + n:].float()
    a = -torch.exp(p["a_log"])                                 # (Di,N)

    xf = xh.float()
    chunk = min(cfg.ssm.chunk_size, s)
    assert s % chunk == 0
    if isinstance(dt, DTensor):
        y, ssm_state = _selective_scan_sharded(dt, b_ssm, c_ssm, xf, a,
                                               state["ssm"], chunk)
    else:
        y, ssm_state = _selective_scan(dt, b_ssm, c_ssm, xf, a,
                                       state["ssm"], chunk)

    y = y + along_features(p["d_skip"], xf) * xf
    out = mm(y.to(x.dtype) * F.silu(z), p["out_proj"])
    return out, {"conv": conv_state, "ssm": ssm_state}


def mamba_state_init(cfg, batch, device, dtype=torch.float32):
    di = cfg.d_model * cfg.ssm.expand
    return {
        "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.ssm.d_state), dtype=torch.float32,
                           device=device),
    }
